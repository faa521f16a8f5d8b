"""The plain reference against the port's plain path, at a tiny size on the
CPU: the grouping index for index, the serving forwards and the fine-tuning
steps of the two families in f32. (The test may import the port; the
reference does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.check import compare_training
from portbench.reference import apf as ref_apf
from portbench.reference import grouping
from portbench.reference import pix4point as ref_p4p
from portbench.reference.layers import F32, FP8, make_weights
from portbench.reference.train import train_steps

APF = dict(num_classes=10, in_channels=3, embedding_dim=64, npoint=32, nsample=16, depth=2,
           num_heads=4, encoder_second_width=32, adapter_bottleneck=64, bf16=False, points=256)
P4P = dict(model_name="Pix4Point", num_classes=5, pretrained_model="vit_small_patch16_384",
           pretrained=False, frozen=False, k_neighbors=16, embed_dim=64, depth=2, num_heads=4,
           bf16=False, points=256)
TRAIN = dict(batch_size=8, learning_rate=5e-4, weight_decay=5e-2, epochs=150, t_max=100,
             warmup_epochs=10, min_lr=1e-6, grad_norm_clip=10)


def _port(family: str, cfg: dict, weights: dict, implementation="torch"):
    from pointvit_tpu_torch.models.factory import build_model

    model = build_model(cfg, family, implementation=implementation)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _clouds(n: int, points: int, seed: int) -> torch.Tensor:
    return generator.shape_clouds(n, points, seed, "cpu")[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouping_is_the_ports_index_for_index(seed):
    from pointvit_tpu_torch.ops.group import apf_group, p3_group

    pts = _clouds(4, 512, seed)
    got = grouping.apf_group(pts, 64, 16)
    want, _ = apf_group(pts, pts, 64, 16, implementation="torch")
    assert torch.equal(got, want)
    start = torch.tensor([3, 100, 511, 0])
    centers, groups = grouping.p3_group(pts, pts, 128, 16, start)
    c2, gp, gf = p3_group(pts, pts, 128, 16, start=start, implementation="torch")
    assert torch.equal(centers, c2) and torch.equal(groups, torch.cat([gp, gf], dim=-1))


@pytest.mark.parametrize("family,cfg,ref", [("apf", APF, ref_apf), ("pix4point", P4P, ref_p4p)])
def test_serving_forward_matches_the_port_in_f32(family, cfg, ref):
    w = make_weights(ref.spec(cfg), 7, "cpu")
    pts = _clouds(6, cfg["points"], 3)
    with torch.no_grad():
        want = _port(family, cfg, w)(pts).float()
    got = ref.forward(w, pts, cfg)
    assert ((got - want).norm() / want.norm()).item() < 1e-5


@pytest.mark.parametrize("family,cfg,ref", [("apf", APF, ref_apf), ("pix4point", P4P, ref_p4p)])
def test_fp8_control_lies_far_from_f32(family, cfg, ref):
    w = make_weights(ref.spec(cfg), 8, "cpu")
    pts = _clouds(6, cfg["points"], 4)
    f32, fp8 = ref.forward(w, pts, cfg, F32), ref.forward(w, pts, cfg, FP8)
    assert ((fp8 - f32).norm() / f32.norm()).item() > 1e-2


def test_make_weights_is_seeded_and_spares_no_init():
    spec = ref_apf.spec(APF)
    a, b, c = (make_weights(spec, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[n], b[n]) for n in spec)
    assert not torch.equal(a["blocks.0.mlp.fc1.weight"], c["blocks.0.mlp.fc1.weight"])
    assert a["blocks.0.adapter.up_proj.weight"].abs().min() > 0
    assert (a["head.bn0.running_var"] > 0.5).all()


def test_training_steps_match_the_ports_trainer_in_f32(tmp_path):
    from pointvit_tpu_torch.train.pix4point_trainer import pix4point_optimizer
    from pointvit_tpu_torch.train.trainer import Trainer

    cfg = P4P
    w = make_weights(ref_p4p.spec(cfg), 9, "cpu")
    gen = torch.Generator().manual_seed(1)
    clouds, labels = generator.shape_clouds(24, cfg["points"], 5, "cpu", classes=5)
    batches = [(generator.augment(clouds[i * 8:(i + 1) * 8], gen), labels[i * 8:(i + 1) * 8])
               for i in range(3)]
    model = _port("pix4point", cfg, w).train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    sched, opt = pix4point_optimizer(model, TRAIN, 3)
    tr = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                 batch_size=8, epochs=1, output_dir=str(tmp_path), seed=11, device="cpu",
                 train_loader=[], test_loader=[], save_config_snapshot=False, prefetch=0)
    losses, first, seen = [], {}, []
    stats = {n: b for n, b in model.named_buffers() if "running_" in n}
    init.update({n: b.detach().clone() for n, b in stats.items()})
    hook = model.register_forward_hook(lambda _m, _a, out: seen.append(out.detach()))
    for i, b in enumerate(batches):
        losses.append(float(tr.train_step(*b)[0]))
        if i == 0:  # the first clipped gradient, from AdamW's first moment
            adam = tr.optimizer.optimizer
            first = {n: adam.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()}
    params = dict(model.named_parameters())
    got = {"logits": seen[0], "change": {n: p.detach() - init[n] for n, p in params.items()},
           "stats": {n: b.detach() - init[n] for n, b in stats.items()},
           "moments": {n: (adam.state[p]["exp_avg"], adam.state[p]["exp_avg_sq"])
                       for n, p in params.items()}}
    want = train_steps(lambda w_, p, **kw: ref_p4p.forward(w_, p, cfg, **kw), w, batches, TRAIN,
                       3, 11, "cpu")
    hook.remove()
    # f32 on both sides: rounding alone. The train-mode head normalises by
    # the batch's statistics, which leaves the small part of the features
    # that differs between clouds and magnifies rounding in the logits; the
    # entries whose gradient is nought to rounding (biases before a
    # BatchNorm) are left out of the change and the moments by the rule.
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])) < 1e-5
    median = float(torch.stack([g.norm() for g in want["first_grad"].values()]).median())
    assert max(float((first[n] - g).norm()) / max(float(g.norm()), median)
               for n, g in want["first_grad"].items()) < 1e-4
    numbers = compare_training(got, want)
    assert numbers["logits_first_rel_l2"] < 1e-4 and numbers["change_worst"] < 1e-2
    assert numbers["adam_state_median"] < 1e-2 and numbers["bn_stats_worst"] < 1e-4
