"""Rank bodies of the port's multi-rank CPU tests (gloo process groups).

Torch-only on purpose: the test modules import JAX, and every rank is a
fresh interpreter that imports this module instead. A test writes its
inputs to a work directory, :func:`spawn` starts the ranks (up to 4) with a
join timeout, each rank runs every case of its suite (sub-worlds of 2 or 4
ranks, each through its own ``FileStore``, so no port is fixed) and saves
its results there, and the test reads them back.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def spawn(suite: str, workdir: str, world: int = 4, timeout: float = 240.0) -> None:
    """Run ``suite`` on ``world`` gloo ranks; raise with a rank's traceback
    when one fails, or when they are not done within ``timeout`` seconds (a
    hung collective fails instead of holding the run)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    code = "import sys, torch_dist_cases as c; c.rank_main(sys.argv[1], int(sys.argv[2]), " \
           "int(sys.argv[3]), sys.argv[4])"
    procs = [subprocess.Popen([sys.executable, "-c", code, suite, str(r), str(world), workdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise TimeoutError(f"{suite}: ranks not done within {timeout} s")
    bad = [(r, p.returncode, o.decode(errors="replace")[-4000:])
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise RuntimeError("\n".join(f"rank {r} exited {rc}:\n{o}" for r, rc, o in bad))


def rank_main(suite: str, rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    try:
        SUITES[suite](rank, world, workdir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


@contextlib.contextmanager
def ranks(rank: int, n: int, workdir: str, tag: str):
    """A gloo group of ranks 0..n−1 for the body; ranks ≥ n skip it
    (yields False)."""
    if rank >= n:
        yield False
        return
    store = dist.FileStore(os.path.join(workdir, f"store_{tag}"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
    try:
        yield True
    finally:
        dist.barrier()
        dist.destroy_process_group()


def save(workdir: str, name: str, rank: int, **tensors) -> None:
    torch.save({k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
                for k, v in tensors.items()}, os.path.join(workdir, f"{name}_{rank}.pt"))


def load_inputs(workdir: str) -> dict:
    return torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)


def _full(t):
    """A whole copy of a (possibly sharded) tensor."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def snapshot(state: dict) -> dict:
    return {k: _full(v) for k, v in state.items()}


# -- parallel: DP / DP×TP / FSDP training, serving, batch_shard_map ---------

APF_CFG = dict(num_classes=15, in_channels=4, embedding_dim=32, npoint=16, nsample=8,
               depth=2, num_heads=4)


def apf_trainer(model, workdir, tag, **kw):
    from pointvit_tpu_torch.models import apf_trainable_mask
    from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule

    opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=1e-2,
                          trainable_mask=apf_trainable_mask(model), grad_clip=kw.pop("grad_clip", None))
    data = [(np.zeros((64, 4), np.float32), 0)] * 16
    return Trainer(model, train_dataset=data, test_dataset=data, optimizer=opt, batch_size=16,
                   epochs=1, label_smoothing=0.3, output_dir=os.path.join(workdir, tag),
                   device="cpu", save_config_snapshot=False, prefetch=0, seed=3, **kw)


def apf_model(inputs, implementation=None):
    from pointvit_tpu_torch.models import AdaptPointFormer

    model = AdaptPointFormer(**APF_CFG, implementation=implementation)
    model.load_state_dict(inputs["apf_state"])
    return model


def _apf_step(trainer, points, labels, steps=1):
    losses = []
    for _ in range(steps):
        loss, _, _ = trainer.train_step(torch.from_numpy(points), torch.from_numpy(labels))
        losses.append(loss)
    return torch.stack(losses)


def _rows(a, r, n):
    per = len(a) // n
    return a[r * per:(r + 1) * per]


def _grads(model) -> dict:
    """Whole copies of the gradients the last step applied."""
    return {n: _full(p.grad) for n, p in model.named_parameters() if p.grad is not None}


def suite_parallel(rank, world, workdir):
    from pointvit_tpu_torch.ops.attention_kernel import fused_mha_qkv
    from pointvit_tpu_torch.parallel import batch_shard_map, make_hybrid_mesh, make_mesh
    from pointvit_tpu_torch.serve import InferenceSession

    inputs = load_inputs(workdir)
    pts, lbl = inputs["points"], inputs["labels"]

    if rank == 0:  # the one-process step every layout is held to
        tr = apf_trainer(apf_model(inputs), workdir, "single", ema_decay=0.5, grad_clip=1.0)
        loss = _apf_step(tr, pts, lbl)
        save(workdir, "single", rank, loss=loss, state=tr.model.state_dict(), ema=tr.ema,
             grads=_grads(tr.model))
        tr_tp = apf_trainer(apf_model(inputs, "torch"), workdir, "single_tp")
        save(workdir, "single_tp", rank, loss=_apf_step(tr_tp, pts, lbl),
             state=tr_tp.model.state_dict(), grads=_grads(tr_tp.model))

    with ranks(rank, 4, workdir, "dp4") as on:
        if on:
            mesh = make_mesh(device_type="cpu")
            tr = apf_trainer(apf_model(inputs), workdir, "dp", mesh=mesh, ema_decay=0.5,
                             grad_clip=1.0)
            loss = _apf_step(tr, _rows(pts, rank, 4), _rows(lbl, rank, 4))
            loss = tr._sum_over_ranks(loss) / 4
            save(workdir, "dp", rank, loss=loss, state=tr.model.state_dict(), ema=tr.ema,
                 grads=_grads(tr.model))
            # the mesh helpers
            from pointvit_tpu_torch.parallel import make_multihost_mesh, replicate, shard_batch

            multi = make_multihost_mesh(model_parallel=2, device_type="cpu")
            hybrid = make_hybrid_mesh(model_parallel=2, device_type="cpu")
            rows = shard_batch(mesh, np.arange(8))
            value = replicate(torch.tensor([float(rank), 1.0]), mesh)
            save(workdir, "helpers", rank, multihost=list(multi.mesh.shape), rows=rows,
                 replicated=value, hybrid=list(hybrid.mesh.shape))

    with ranks(rank, 4, workdir, "dptp") as on:
        if on:
            mesh = make_hybrid_mesh(model_parallel=2, device_type="cpu")
            tr = apf_trainer(apf_model(inputs, "torch"), workdir, "dptp", mesh=mesh)
            d = mesh.get_local_rank("data")
            loss = _apf_step(tr, _rows(pts, d, 2), _rows(lbl, d, 2))
            loss = tr._sum_over_ranks(loss) / 2
            state = snapshot(tr.model.state_dict())
            qkv = tr.model.blocks[0].attention.qkv.weight
            save(workdir, "dptp", rank, loss=loss, state=state, grads=_grads(tr.model),
                 local_rows=torch.tensor(qkv.to_local().shape[0]))
            # A ViT block at the fused gate's shape: the kernel path refuses
            # tensor-parallel weights, the plain path runs them unfused.
            from torch.distributed.tensor.parallel import parallelize_module

            from pointvit_tpu_torch.nn.vit import ViTBlock
            from pointvit_tpu_torch.parallel import transformer_tp_shardings

            torch.manual_seed(7)
            block = ViTBlock(128, 2).eval()
            x = torch.randn(2, 10, 128)
            with torch.no_grad():
                want = block(x)
            plan = transformer_tp_shardings(block, mesh)
            parallelize_module(block, mesh["model"], plan)
            try:
                with torch.no_grad():
                    block(x)
                raised = ""
            except ValueError as e:
                raised = str(e)
            block.implementation = block.attn.implementation = "torch"
            with torch.no_grad():
                got = block(x)
            save(workdir, "dptp_block", rank, raised=raised, want=want, got=got,
                 plan=sorted(f"{k}:{type(v).__name__}" for k, v in plan.items()))

    with ranks(rank, 2, workdir, "fsdp") as on:
        if on:
            mesh = make_mesh(device_type="cpu")
            tr = apf_trainer(apf_model(inputs), workdir, "fsdp", mesh=mesh, fsdp=True,
                             ema_decay=0.5, grad_clip=1.0)
            loss = _apf_step(tr, _rows(pts, rank, 2), _rows(lbl, rank, 2))
            loss = tr._sum_over_ranks(loss) / 2
            grads = _grads(tr.model)
            sharded = sorted(n for n, p in tr.model.named_parameters() if hasattr(p, "to_local"))
            state = snapshot(tr.model.state_dict())
            ema = snapshot(tr.ema)
            path = tr._save_checkpoint("fsdp.pt", 0, 0.5)
            # AdamW's groups as the FSDP trainer built them, and its moments
            inner = tr.optimizer.optimizer
            groups = [[hasattr(p, "to_local") for p in g["params"]] + [g["foreach"]]
                      for g in inner.param_groups]
            moments = {n: _full(inner.state[p]["exp_avg"])
                       for n, p in tr.model.named_parameters() if p in inner.state}
            # A resume shards the checkpoint again and takes the same next step.
            tr2 = apf_trainer(apf_model(inputs), workdir, "fsdp", mesh=mesh, fsdp=True,
                              ema_decay=0.5, grad_clip=1.0)
            tr2.load_checkpoint(path)
            resumed = snapshot(tr2.model.state_dict())
            resumed_ema = snapshot(tr2.ema)
            for t in (tr, tr2):  # the generator's state is not part of a checkpoint
                t.generator.manual_seed(11)
            n1 = _apf_step(tr, _rows(pts, rank, 2), _rows(lbl, rank, 2), 1)
            n2 = _apf_step(tr2, _rows(pts, rank, 2), _rows(lbl, rank, 2), 1)
            after1, after2 = snapshot(tr.model.state_dict()), snapshot(tr2.model.state_dict())
            # Evaluation under FSDP swaps the sharded EMA in and back out.
            with torch.no_grad():
                ev = tr._eval_forward(torch.from_numpy(_rows(pts, rank, 2)))
            save(workdir, "fsdp", rank, loss=loss, state=state, ema=ema, sharded=sharded, grads=grads,
                 resumed=resumed, resumed_ema=resumed_ema, n1=n1, n2=n2, after1=after1,
                 after2=after2, path=path, eval=ev, ema_after1=snapshot(tr.ema),
                 after_eval=snapshot(tr.model.state_dict()), groups=groups, moments=moments)

    with ranks(rank, 2, workdir, "bn") as on:  # BatchNorm + ReLU over the global batch
        if on:
            from pointvit_tpu_torch.nn.layers import batch_norm_relu
            from pointvit_tpu_torch.parallel.comm import global_batch

            def bn_run(x, w, rows=None):
                bn = torch.nn.BatchNorm1d(x.shape[-1], eps=1e-5, momentum=0.1)
                bn.load_state_dict(inputs["bn_state"])
                x = x.clone().requires_grad_()
                with global_batch(dist.group.WORLD, len(x)) if rows else contextlib.nullcontext():
                    y = batch_norm_relu(x, bn, train=True)
                (y * w).sum().backward()
                return dict(y=y.detach(), dx=x.grad, dgamma=bn.weight.grad, dbeta=bn.bias.grad,
                            mean=bn.running_mean, var=bn.running_var)

            x, w = inputs["bn_x"], inputs["bn_w"]
            save(workdir, "bn", rank, **bn_run(_rows(x, rank, 2), _rows(w, rank, 2), rows=True))
            if rank == 0:
                save(workdir, "bn_single", rank, **bn_run(x, w))

    with ranks(rank, 2, workdir, "serve") as on:
        if on:
            mesh = make_mesh(device_type="cpu")
            model = apf_model(inputs)
            sess = InferenceSession(model, buckets=(3, 8), device="cpu", mesh=mesh)
            logits = sess.predict_logits(pts[:5])
            sess1 = InferenceSession(apf_model(inputs), buckets=(3, 8), device="cpu")
            save(workdir, "serve", rank, logits=torch.from_numpy(logits),
                 single=torch.from_numpy(sess1.predict_logits(pts[:5])),
                 buckets=torch.tensor(sess.buckets))
            # batch_shard_map over the attention wrapper (its plain version on the CPU)
            qkv = torch.from_numpy(inputs["qkv"])
            fn = batch_shard_map(lambda x: fused_mha_qkv(x, 4), mesh)
            save(workdir, "shard_map", rank, out=fn(qkv), direct=fused_mha_qkv(qkv, 4))


# -- moe: expert parallelism and the MoE trunk under DP ----------------------

def suite_moe(rank, world, workdir):
    from pointvit_tpu_torch.parallel import make_hybrid_mesh, make_mesh, moe_ffn

    inputs = load_inputs(workdir)
    x = torch.from_numpy(inputs["x"])
    g = torch.from_numpy(inputs["cot"])
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}

    def ep_case(tag, mesh, rows, data_axis, **kw):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xl = rows(x).clone().requires_grad_(True)
        out, aux = moe_ffn(xl, p, mesh, data_axis=data_axis, **kw)
        (out * rows(g)).sum().backward()
        save(workdir, tag, rank, out=out, aux=aux, gx=xl.grad,
             **{f"g_{k}": v.grad for k, v in p.items()})

    for n in (2, 4):
        with ranks(rank, n, workdir, f"ep{n}") as on:
            if on:
                mesh = make_mesh(axis_name="expert", device_type="cpu")
                for top_k in (1, 2):
                    for cf in (4.0, 0.5):
                        ep_case(f"ep{n}_k{top_k}_cf{cf}", mesh, lambda a: _rows(a, rank, n), None,
                                top_k=top_k, capacity_factor=cf)
                ep_case(f"ep{n}_norm", mesh, lambda a: _rows(a, rank, n), None,
                        normalize_gates=True)
    with ranks(rank, 4, workdir, "dpep") as on:
        if on:
            mesh = make_hybrid_mesh(model_parallel=2, data_axis="data", model_axis="expert",
                                    device_type="cpu")
            ep_case("dpep", mesh, lambda a: _rows(a, rank, 4), "data", capacity_factor=4.0)

    # The MoE Pix4Point trunk under DP: the one-process step, then 2 ranks.
    for cf in (2.0, 0.5):
        tag = f"moe_dp_cf{cf}"
        if rank == 0:
            tr = pix4point_moe_trainer(inputs, workdir, f"{tag}_single", cf)
            loss = _apf_step(tr, inputs["clouds"], inputs["clouds_labels"])
            save(workdir, f"{tag}_single", rank, loss=loss, state=tr.model.state_dict(),
                 grads=_grads(tr.model))
        with ranks(rank, 2, workdir, tag) as on:
            if on:
                tr = pix4point_moe_trainer(inputs, workdir, tag, cf, mesh=make_mesh(device_type="cpu"))
                loss = _apf_step(tr, _rows(inputs["clouds"], rank, 2),
                                 _rows(inputs["clouds_labels"], rank, 2))
                save(workdir, tag, rank, loss=tr._sum_over_ranks(loss) / 2,
                     state=tr.model.state_dict(), grads=_grads(tr.model))


P4P_MOE = dict(num_classes=15, embed_dim=32, depth=2, num_heads=4, k_neighbors=4,
               moe_experts=4, moe_every=2)


def pix4point_moe_trainer(inputs, workdir, tag, cf, **kw):
    from pointvit_tpu_torch.models import Pix4Point
    from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule

    model = Pix4Point(**P4P_MOE)
    model.load_state_dict(inputs["p4p_state"])
    for m in model.modules():
        if hasattr(m, "capacity_factor"):
            m.capacity_factor = cf
    opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=5e-2, grad_clip=10.0)
    data = [(np.zeros((64, 3), np.float32), 0)] * 8
    return Trainer(model, train_dataset=data, test_dataset=data, optimizer=opt, batch_size=8,
                   epochs=1, output_dir=os.path.join(workdir, tag), device="cpu",
                   save_config_snapshot=False, prefetch=0, seed=5,
                   train_config={"moe_aux_weight": 0.5}, **kw)


# -- seq_pipe: ring and Ulysses attention, the GPipe schedule --------------

def suite_seq_pipe(rank, world, workdir):
    from torch.func import functional_call

    from pointvit_tpu_torch.nn.vit import ViTBlock
    from pointvit_tpu_torch.parallel import make_hybrid_mesh, make_mesh, pipeline_blocks
    from pointvit_tpu_torch.parallel import ring_mha, ulysses_mha

    inputs = load_inputs(workdir)
    q, k, v, g = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v", "cot"))

    def seq_case(tag, fn, mesh, n_seq, n_data, dtype=torch.float32):
        s_idx = mesh.get_local_rank("seq")
        d_idx = mesh.get_local_rank("data") if n_data > 1 else 0

        def block(a):
            return _rows(_rows(a, d_idx, n_data).transpose(0, 1), s_idx, n_seq).transpose(0, 1)

        ql, kl, vl = (block(a).to(dtype).clone().requires_grad_(True) for a in (q, k, v))
        out = fn(ql, kl, vl, mesh, data_axis="data" if n_data > 1 else None)
        (out.float() * block(g)).sum().backward()
        save(workdir, tag, rank, out=out.float(), gq=ql.grad.float(), gk=kl.grad.float(),
             gv=vl.grad.float(), s=torch.tensor(s_idx), d=torch.tensor(d_idx))

    for n in (2, 4):
        with ranks(rank, n, workdir, f"seq{n}") as on:
            if on:
                mesh = make_mesh(axis_name="seq", device_type="cpu")
                seq_case(f"ring{n}", ring_mha, mesh, n, 1)
                seq_case(f"ulysses{n}", ulysses_mha, mesh, n, 1)
                seq_case(f"ring{n}_bf16", ring_mha, mesh, n, 1, torch.bfloat16)
                seq_case(f"ulysses{n}_bf16", ulysses_mha, mesh, n, 1, torch.bfloat16)
                try:
                    ulysses_mha(q[:, :4, :3], k[:, :4, :3], v[:, :4, :3], mesh)
                    raised = ""
                except ValueError as e:
                    raised = str(e)
                save(workdir, f"ulysses{n}_raise", rank, raised=raised)
    with ranks(rank, 4, workdir, "seqdp") as on:
        if on:
            mesh = make_hybrid_mesh(model_parallel=2, data_axis="data", model_axis="seq",
                                    device_type="cpu")
            seq_case("ring_dp", ring_mha, mesh, 2, 2)
            seq_case("ulysses_dp", ulysses_mha, mesh, 2, 2)

    block = ViTBlock(32, 4, implementation="torch")
    stacked = {n: torch.from_numpy(t) for n, t in inputs["stacked"].items()}
    tokens = torch.from_numpy(inputs["tokens"])
    tcot = torch.from_numpy(inputs["tokens_cot"])

    def apply(p, x):
        return functional_call(block, p, (x,), {"train": True})

    def pipe_case(tag, mesh, n_micro, remat=False, n_data=1):
        p = {k: t.clone().requires_grad_(True) for k, t in stacked.items()}
        d = mesh.get_local_rank("data") if n_data > 1 else 0
        toks = _rows(tokens, d, n_data).clone().requires_grad_(True)
        out = pipeline_blocks(apply, p, toks, mesh, n_microbatches=n_micro, remat=remat,
                              data_axis="data" if n_data > 1 else None)
        (out * _rows(tcot, d, n_data)).sum().backward()
        save(workdir, tag, rank, out=out, gt=toks.grad, d=torch.tensor(d),
             **{f"g_{k}": t.grad for k, t in p.items()})

    for n, micro in ((4, 4), (2, 1), (4, 2)):
        with ranks(rank, n, workdir, f"pipe{n}_{micro}") as on:
            if on:
                mesh = make_mesh(axis_name="pipe", device_type="cpu")
                pipe_case(f"pipe{n}_{micro}", mesh, micro)
                if (n, micro) == (4, 2):
                    pipe_case("pipe_remat", mesh, micro, remat=True)
    with ranks(rank, 4, workdir, "pipedp") as on:
        if on:
            mesh = make_hybrid_mesh(model_parallel=2, data_axis="data", model_axis="pipe",
                                    device_type="cpu")
            pipe_case("pipe_dp", mesh, 2, n_data=2)


# -- layouts: the Trainer on (data x model) FSDP, (data x expert) and 3-D meshes --

LAYOUT_STEPS = 3
P4P_LAYOUT = dict(num_classes=15, embed_dim=32, depth=2, num_heads=4, k_neighbors=4, moe_experts=4,
                  moe_every=2)
P4P_LAYOUT_CONFIG = {"model_name": "Pix4Point", "pretrained_model": "vit_small_patch16_384",
                     "pretrained": False, "bf16": False, **P4P_LAYOUT}


def _deterministic(model):
    """No dropout, and FPS from point 0: the JAX side draws other numbers,
    so the layouts are held against it with no random draw."""
    import pointvit_tpu_torch.models.apf as apf
    import pointvit_tpu_torch.nn.pointnet as pointnet
    from pointvit_tpu_torch.nn.layers import Dropout, DropPath

    zeros = lambda points, generator: torch.zeros(points.shape[0], dtype=torch.long)  # noqa: E731
    apf.random_starts = pointnet.random_starts = zeros
    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.rate = 0.0
    return model


# AdamW's eps for the layouts: with the default 1e-8 a first step moves each
# entry by about lr·sign(g), so rounding noise in a small gradient becomes a
# whole step; at 1e-3 the update of the small entries is near linear in g
# and the runs can be held at rounding level.
LAYOUT_EPS = 1e-3


def _layout_apf(inputs, workdir, tag, implementation=None, **kw):
    from pointvit_tpu_torch.models import apf_trainable_mask
    from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule

    model = _deterministic(apf_model(inputs, implementation))
    opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=1e-2, grad_clip=1.0,
                          trainable_mask=apf_trainable_mask(model), eps=LAYOUT_EPS)
    data = [(np.zeros((64, 4), np.float32), 0)] * 16
    return Trainer(model, train_dataset=data, test_dataset=data, optimizer=opt, batch_size=16,
                   epochs=1, label_smoothing=0.3, output_dir=os.path.join(workdir, tag),
                   device="cpu", save_config_snapshot=False, prefetch=0, seed=3, ema_decay=0.5,
                   **kw)


def _layout_moe(inputs, workdir, tag, cf, mesh=None, aux_weight=0.5):
    from pointvit_tpu_torch.models import Pix4Point
    from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule
    from pointvit_tpu_torch.train.pix4point_trainer import no_decay_names

    mkw = dict(moe_mesh=mesh, moe_data_axis="data") if mesh is not None else {}
    model = _deterministic(Pix4Point(**P4P_LAYOUT, **mkw))
    model.load_state_dict(inputs["moe"][cf]["state"])
    for m in model.modules():
        if hasattr(m, "capacity_factor"):
            m.capacity_factor = cf
    opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=5e-2, grad_clip=1.0,
                          no_decay=no_decay_names(model), eps=LAYOUT_EPS)
    data = [(np.zeros((64, 3), np.float32), 0)] * 8
    return Trainer(model, train_dataset=data, test_dataset=data, optimizer=opt, batch_size=8,
                   epochs=1, output_dir=os.path.join(workdir, tag), device="cpu",
                   save_config_snapshot=False, prefetch=0, seed=5, mesh=mesh,
                   model_config=P4P_LAYOUT_CONFIG, train_config={"moe_aux_weight": aux_weight})


@contextlib.contextmanager
def max_gaps():
    """Record, for every ``amax`` over a tensor that takes a gradient (the
    group, token and pooling maxima), the least relative gap between the
    largest and the second largest entry along the reduced axis: a near tie
    there sends the max's gradient to another row on a side that rounds
    differently (ties of zeros, after a ReLU, pass no gradient)."""
    real, gaps = torch.Tensor.amax, []

    def amax(self, dim=(), keepdim=False):
        if self.requires_grad and self.shape[dim] > 1:
            with torch.no_grad():
                top = self.detach().double().topk(2, dim=dim).values
                lead = top.select(dim, 0)
                gap = (lead - top.select(dim, 1)) / lead.abs().clamp_min(1e-30)
                live = lead != 0  # a tie of zeros after a ReLU passes no gradient
                if live.any():
                    gaps.append(float(gap[live].min()))
        return real(self, dim, keepdim)

    torch.Tensor.amax = amax
    try:
        yield gaps
    finally:
        torch.Tensor.amax = real


def _router_gaps(model):
    """Record, on every forward of each MoE layer, the least relative gap
    between a token's k-th and (k+1)-th router probabilities."""
    from pointvit_tpu_torch.nn.moe import MoEMlp

    gaps = []

    def hook(m, args):
        gate = m.gate.detach()
        p = torch.softmax(args[0].detach().reshape(-1, gate.shape[0]).double() @ gate.double(), -1)
        top = p.sort(-1, descending=True).values
        gaps.append(float(((top[:, :m.top_k] - top[:, 1:m.top_k + 1]) / top[:, :m.top_k]).min()))

    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.register_forward_pre_hook(hook)
    return gaps


def _dtensor_layout(model):
    """name → (mesh dims, the tensor dims sharded, None where replicated)
    of the DTensor parameters."""
    return {n: (p.device_mesh.mesh_dim_names,
                [None if q.is_replicate() else q.dim for q in p.placements])
            for n, p in model.named_parameters() if hasattr(p, "placements")}


def _host(tree):
    """``tree`` with every tensor a CPU copy (dicts and lists walked)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _trajectory(tr, batch, steps=LAYOUT_STEPS):
    """``steps`` training steps on this rank's rows ``batch``: the mean loss
    of each over the rows' ranks, and the whole state (model, optimizer,
    EMA: a collective on every rank) before the first and after each."""
    states, losses = [_host(tr._checkpoint_state())], []
    for _ in range(steps):
        losses.append(tr._sum_over_ranks(_apf_step(tr, *batch)[0]) / tr.world)
        states.append(_host(tr._checkpoint_state()))
    return torch.stack(losses), states


def _replay(tr, states, batch):
    """The one-process trainer's step from each state of a trajectory but
    the last, on the whole batch: its loss and the state after it."""
    losses, after = [], []
    for st in states[:-1]:
        tr.model.load_state_dict(st["model"])
        tr.optimizer.load_state_dict(st["optimizer"])
        if st["ema"] is not None:
            tr.ema = {k: v.clone() for k, v in st["ema"].items()}
        losses.append(_apf_step(tr, *batch)[0])
        after.append(_host(tr._checkpoint_state()))
    return torch.stack(losses), after


def suite_layouts(rank, world, workdir):
    from pointvit_tpu_torch.parallel import make_hybrid_mesh, make_multihost_mesh
    from pointvit_tpu_torch.train.checkpoint import wait_for_pending_writes

    inputs = load_inputs(workdir)
    pts, lbl = inputs["points"], inputs["labels"]

    def clouds(cf, r=None):
        case = inputs["moe"][cf]
        if r is None:
            return case["clouds"], case["labels"]
        return _rows(case["clouds"], r, 4), _rows(case["labels"], r, 4)

    def replay(tag, make, batch):  # rank 0 holds each step of a layout's run to one process
        if rank == 0:
            got = torch.load(os.path.join(workdir, f"{tag}_0.pt"), weights_only=False)
            with max_gaps() as gaps:
                loss, after = _replay(make(), got["states"], batch)
            save(workdir, f"{tag}_replay", rank, loss=loss, states=after, gaps=gaps)

    with ranks(rank, 4, workdir, "fsdp_tp") as on:  # (i) data 2 x model 2, FSDP over the TP plan
        if on:
            mesh = make_hybrid_mesh(model_parallel=2, device_type="cpu")
            tr = _layout_apf(inputs, workdir, "fsdp_tp", "torch", mesh=mesh, fsdp=True)
            d = mesh.get_local_rank("data")
            with max_gaps() as gaps:
                loss, states = _trajectory(tr, (_rows(pts, d, 2), _rows(lbl, d, 2)))
            # each sharded parameter laid out again from its whole tensor
            relaid = all(torch.equal(tr._shard_like(_full(p), p).to_local(), p.to_local())
                         for p in tr.model.parameters() if hasattr(p, "to_local"))
            path = tr._save_checkpoint("fsdp_tp.pt", 0, 0.5)
            tr2 = _layout_apf(inputs, workdir, "fsdp_tp", "torch", mesh=mesh, fsdp=True)
            tr2.load_checkpoint(path)
            save(workdir, "fsdp_tp", rank, loss=loss, states=states, gaps=gaps, relaid=relaid,
                 layout=_dtensor_layout(tr.model), resumed=_host(tr2._checkpoint_state()))
    replay("fsdp_tp", lambda: _layout_apf(inputs, workdir, "fsdp_tp_one", "torch"), (pts, lbl))

    for cf in (2.0, 4.0):  # (ii) MoE Pix4Point, data 2 x expert 2
        tag = f"moe_ep_cf{cf}"
        # cf 2 is held to JAX; at cf 4 no token drops and, without the
        # load-balance term (the mean of each shard's under expert
        # parallelism, as in JAX), a step is the one-process step.
        aux = 0.5 if cf == 2.0 else 0.0
        with ranks(rank, 4, workdir, tag) as on:
            if on:
                mesh = make_hybrid_mesh(model_parallel=2, model_axis="expert", device_type="cpu")
                tr = _layout_moe(inputs, workdir, tag, cf, mesh=mesh, aux_weight=aux)
                router = _router_gaps(tr.model)
                with max_gaps() as gaps:
                    loss, states = _trajectory(tr, clouds(cf, rank))
                path = tr._save_checkpoint(f"{tag}.pt", 0, 0.5)
                wait_for_pending_writes()
                save(workdir, tag, rank, loss=loss, states=states, gaps=gaps + router,
                     layout=_dtensor_layout(tr.model), path=path)
        if cf == 4.0:
            replay(tag, lambda: _layout_moe(inputs, workdir, "moe_one", cf, aux_weight=aux),
                   clouds(cf))

    with ranks(rank, 4, workdir, "replica") as on:  # (iii) replica 2 x data 2 x model 1
        if on:
            os.environ["LOCAL_WORLD_SIZE"] = "2"
            mesh = make_multihost_mesh(device_type="cpu")
            tr = _layout_apf(inputs, workdir, "replica", mesh=mesh)
            d = mesh.get_local_rank("data")
            with max_gaps() as gaps:
                loss, states = _trajectory(tr, (_rows(pts, d, 2), _rows(lbl, d, 2)))
            save(workdir, "replica", rank, loss=loss, states=states, gaps=gaps,
                 shape=list(mesh.mesh.shape))
    replay("replica", lambda: _layout_apf(inputs, workdir, "replica_one"), (pts, lbl))


SUITES = {"parallel": suite_parallel, "moe": suite_moe, "seq_pipe": suite_seq_pipe,
          "layouts": suite_layouts}
