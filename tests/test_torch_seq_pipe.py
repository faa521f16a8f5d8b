"""Port parity for sequence parallelism (``ring_mha``, ``ulysses_mha``) and
the GPipe schedule (``pipeline_blocks``) on the CPU: gloo ranks
(``tests/torch_dist_cases.py::suite_seq_pipe``, one spawn of 4) against the
JAX functions on a mesh of the same shape over the first W virtual devices.

Attention: B 4, S 16, 4 heads of 8; sequence over 2 and 4 ranks and over
(data 2 × seq 2); outputs within 1e-5, the gradients of q, k and v within
1e-4; bf16 inputs within 2e-2 (both accumulate in f32 and round the output
to bf16). The pipeline: 8 ViT blocks of width 32 and 4 heads (the port's
plain block against the JAX block's einsum path) on 8 × 5 tokens, over
(stages, microbatches) = (4, 4), (2, 1), (4, 2), with remat, and over
(data 2 × pipe 2); outputs within 1e-5, the gradients of every stacked
weight and of the tokens within 1e-4 (a rank's share summed over the pipe
group).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pointvit_tpu.nn.vit import ViTBlock as JBlock
from pointvit_tpu.parallel import pipeline_blocks as jpipeline_blocks
from pointvit_tpu.parallel import ring_mha as jring_mha
from pointvit_tpu.parallel import ulysses_mha as julysses_mha
from pointvit_tpu_torch import convert
from pointvit_tpu_torch.nn.vit import ViTBlock
from pointvit_tpu_torch.parallel import pipeline_blocks, stack_block_params, unstack_block_params
import torch_dist_cases

HIGHEST = functools.partial(jax.default_matmul_precision, "highest")
B, S, H, D = 4, 16, 4, 8
DEPTH, WIDTH = 8, 32


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _attention_inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, S, H, D)).astype(np.float32) for n in ("q", "k", "v", "cot")}


def _blocks():
    torch.manual_seed(0)
    blocks = torch.nn.ModuleList(ViTBlock(WIDTH, 4, implementation="torch") for _ in range(DEPTH))
    with torch.no_grad():  # live norms
        for n, p in blocks.named_parameters():
            if "norm" in n:
                p.add_(0.1 * torch.randn_like(p))
    return blocks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("seq_pipe_ranks"))
    sd = {f"blocks.{k}": v for k, v in _blocks().state_dict().items()}
    stacked, _ = stack_block_params(sd)
    rng = np.random.default_rng(1)
    torch.save(dict(**_attention_inputs(), stacked={k: v.numpy() for k, v in stacked.items()},
                    tokens=rng.standard_normal((8, 5, WIDTH)).astype(np.float32),
                    tokens_cot=rng.standard_normal((8, 5, WIDTH)).astype(np.float32)),
               os.path.join(wd, "inputs.pt"))
    torch_dist_cases.spawn("seq_pipe", wd, 4, timeout=300)
    return wd, lambda name, r=0: torch.load(os.path.join(wd, f"{name}_{r}.pt"), weights_only=False)


SEQ_CASES = {  # tag → (JAX function, mesh shape, names, ranks, dtype)
    "ring2": (jring_mha, (2,), ("seq",), torch.float32),
    "ring4": (jring_mha, (4,), ("seq",), torch.float32),
    "ulysses2": (julysses_mha, (2,), ("seq",), torch.float32),
    "ulysses4": (julysses_mha, (4,), ("seq",), torch.float32),
    "ring2_bf16": (jring_mha, (2,), ("seq",), torch.bfloat16),
    "ulysses4_bf16": (julysses_mha, (4,), ("seq",), torch.bfloat16),
    "ring_dp": (jring_mha, (2, 2), ("data", "seq"), torch.float32),
    "ulysses_dp": (julysses_mha, (2, 2), ("data", "seq"), torch.float32),
}


@pytest.mark.parametrize("tag", sorted(SEQ_CASES))
def test_sequence_parallel_attention_matches_jax(tag, ranks):
    fn, shape, names, dtype = SEQ_CASES[tag]
    x = _attention_inputs()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    data_axis = "data" if "data" in names else None

    def loss(q, k, v):
        out = fn(q, k, v, _mesh(shape, names), data_axis=data_axis)
        return jnp.sum(out.astype(jnp.float32) * x["cot"]), out

    with HIGHEST():
        (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x[n], jdtype) for n in ("q", "k", "v")))
    n = int(np.prod(shape))
    n_seq, n_data = shape[-1], (shape[0] if len(shape) == 2 else 1)
    got = {k: np.zeros((B, S, H, D), np.float32) for k in ("out", "gq", "gk", "gv")}
    _, load = ranks
    for r in range(n):
        part = load(tag, r)
        s, d = int(part["s"]), int(part["d"])
        rows = slice(d * B // n_data, (d + 1) * B // n_data)
        cols = slice(s * S // n_seq, (s + 1) * S // n_seq)
        for k in got:
            got[k][rows, cols] = part[k].numpy()
    tol_out, tol_grad = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    np.testing.assert_allclose(got["out"], np.asarray(want, np.float32), rtol=tol_out, atol=tol_out)
    for k, g in zip(("gq", "gk", "gv"), grads):
        np.testing.assert_allclose(got[k], np.asarray(g, np.float32), rtol=tol_grad, atol=tol_grad,
                                   err_msg=k)


def test_ulysses_refuses_heads_the_ranks_do_not_divide(ranks):
    _, load = ranks
    for r in range(4):
        assert "heads 3 not divisible by 4 seq shards" in load("ulysses4_raise", r)["raised"]


def _jax_stacked(blocks):
    trees = [convert.state_dict_to_flax(b)["params"] for b in blocks]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _torch_layout(jgrads, blocks) -> dict:
    """A stacked flax gradient tree in the port's stacked state-dict layout."""
    keys = blocks[0].state_dict().keys()
    per = [convert.flax_to_state_dict({"params": jax.tree.map(lambda a: np.asarray(a[i]), jgrads)},
                                      keys) for i in range(DEPTH)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


PIPE_CASES = {  # tag → (mesh shape, names, microbatches, remat)
    "pipe4_4": ((4,), ("pipe",), 4, False),
    "pipe2_1": ((2,), ("pipe",), 1, False),
    "pipe4_2": ((4,), ("pipe",), 2, False),
    "pipe_remat": ((4,), ("pipe",), 2, True),
    "pipe_dp": ((2, 2), ("data", "pipe"), 2, False),
}


@pytest.mark.parametrize("tag", sorted(PIPE_CASES))
def test_pipeline_blocks_matches_jax(tag, ranks):
    shape, names, micro, remat = PIPE_CASES[tag]
    wd, load = ranks
    inputs = torch_dist_cases.load_inputs(wd)
    blocks = _blocks()
    jblock = JBlock(4, implementation="xla")
    cot = inputs["tokens_cot"]
    data_axis = "data" if "data" in names else None

    def loss(p, t):
        out = jpipeline_blocks(lambda q, x: jblock.apply({"params": q}, x), p, t,
                               _mesh(shape, names), n_microbatches=micro, data_axis=data_axis,
                               remat=remat)
        return jnp.sum(out * cot), out

    with HIGHEST():
        (_, want), (gp, gt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            _jax_stacked(blocks), jnp.asarray(inputs["tokens"]))
    n = int(np.prod(shape))
    parts = [load(tag, r) for r in range(n)]
    n_data = shape[0] if len(shape) == 2 else 1
    per = 8 // n_data
    out = np.zeros_like(np.asarray(want))
    gtok = np.zeros_like(out)
    for p in parts:  # every pipe rank holds its data rows' output; tokens' grads sum
        d = int(p["d"])
        out[d * per:(d + 1) * per] = p["out"].numpy()
        gtok[d * per:(d + 1) * per] += p["gt"].numpy()
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gtok, np.asarray(gt), rtol=1e-4, atol=1e-4)
    want_g = _torch_layout(gp, blocks)
    for k, w in want_g.items():
        got = sum(p[f"g_{k}"] for p in parts)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_stack_and_unstack_round_trip():
    sd = {f"blocks.{k}": v for k, v in _blocks().state_dict().items()}
    stacked, depth = stack_block_params(sd)
    assert depth == DEPTH and stacked["attn.qkv.weight"].shape == (DEPTH, 3 * WIDTH, WIDTH)
    back = unstack_block_params(stacked)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="no 'layers."):
        stack_block_params(sd, prefix="layers.")


def test_pipeline_validates_its_shapes():
    class Stages:  # a mesh's interface, as far as the checks read it
        mesh_dim_names = ("pipe",)

        def __init__(self, n):
            self.n = n

        def get_group(self, _):
            return None

        def size(self, _):
            return self.n

    stacked, _ = stack_block_params({f"blocks.{k}": v for k, v in _blocks().state_dict().items()})
    tokens = torch.zeros(8, 5, WIDTH)
    with pytest.raises(ValueError, match="depth 8 not divisible by 3 stages"):
        pipeline_blocks(lambda p, x: x, stacked, tokens, Stages(3), n_microbatches=2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_blocks(lambda p, x: x, stacked, tokens, Stages(4), n_microbatches=3)
