"""A run with the timed path broken underneath is not correct: each fault a
cell can have, planted at a tiny size on the CPU, and the control (one
precision below bf16) against the sound program on the same seeds. The
card tests read the control at the cells' own sizes."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny
from portbench import check, harness
from portbench.faults import FAULTS
from portbench.kinds import batch, train

SERVING = ["apf_slim2.serve_b256", "pix4point_vit_small.serve_b256"]
SEED = 2**31 + 4242


def _numbers(cell: str, variant: str, seed: int = SEED) -> tuple[dict, dict, dict]:
    config, traffic = tiny(*cell.split("."))
    out = harness.run_cell({"name": cell, "chips": 1}, config, traffic, seed, 0.5, False, "cpu",
                           time.time(), program=batch.serving_program(config, variant))
    assert out["attempted"] > 0 and out["failed"] == 0
    return out["numbers"], config, traffic


def _serve(cell: str, variant: str, seed: int = SEED) -> tuple[bool, dict]:
    numbers, config, traffic = _numbers(cell, variant, seed)
    return check.judge(numbers, harness.limits_of(config["name"], traffic["kind"]))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", SERVING)
def test_a_planted_serving_fault_is_not_correct(cell, fault):
    ok, checks = _serve(cell, fault)
    assert not ok, checks


@pytest.mark.parametrize("cell", SERVING)
def test_the_sound_program_is_correct_at_a_tiny_size(cell):
    ok, checks = _serve(cell, "sound")
    assert ok, checks


def _tiny_training(seed: int = SEED):
    config, traffic = tiny("pix4point_vit_small", "train_b64")
    ctx = harness.context({"name": "tiny", "chips": 1}, config, traffic, seed, 0.3, False, "cpu",
                          time.time())
    return ctx, harness.limits_of(config["name"], "train")


def test_half_of_the_batch_left_out_is_not_correct():
    ctx, limits = _tiny_training()
    half = train.reading(ctx, "half_batch")
    assert not check.judge(half, limits)[0], half


def _state(change, stats, first, second):
    t = torch.tensor
    return {"logits": t([[1.0, 2.0]]), "first_grad": {"a": t([1.0, -1.0]), "b": t([2.0, 0.5])},
            "change": {"a": t(change[0]), "b": t(change[1])},
            "stats": {"bn.running_mean": t(stats[0]), "bn.running_var": t(stats[1])},
            "moments": {"a": (t(first[0]), t(second[0])), "b": (t(first[1]), t(second[1]))}}


def test_a_step_that_returns_its_state_unchanged_reads_one():
    want = _state(([0.1, -0.1], [-0.2, 0.1]), ([0.3, -0.1], [0.2, 0.4]),
                  ([0.1, -0.1], [0.2, 0.05]), ([0.01, 0.01], [0.04, 0.002]))
    zero = ([0.0, 0.0], [0.0, 0.0])
    frozen = _state(zero, zero, zero, zero)
    numbers = check.compare_training(frozen, want)
    assert numbers["change_worst"] == numbers["adam_state_median"] == 1.0
    assert numbers["bn_stats_worst"] == 1.0
    limits = harness.limits_of("pix4point_vit_small", "train")
    assert not check.judge(numbers, limits)[0]
    assert check.compare_training(want, want)["bn_stats_worst"] == 0.0


def test_a_flipped_batchnorm_momentum_shows_in_the_running_statistics(monkeypatch):
    # r <- 0.1 r + 0.9 stat, the convention flip between flax and torch
    from pointvit_tpu_torch.nn import layers

    ctx, _ = _tiny_training()
    sound = train.reading(ctx, "sound")
    monkeypatch.setattr(layers, "BN_MOMENTUM", 0.1)
    ctx, _ = _tiny_training()
    flipped = train.reading(ctx, "sound")
    assert flipped["bn_stats_worst"] > 10 * sound["bn_stats_worst"], (sound, flipped)
    assert flipped["bn_stats_worst"] > 1.0


@pytest.mark.parametrize("cell", ["apf_slim2.serve_b256", "pix4point_vit_small.serve_b256"])
def test_the_control_lies_further_from_the_reference(cell):
    sound = [_serve(cell, "sound", s)[1] for s in (1, 2)]
    control = [_serve(cell, "control", s)[1] for s in (1, 2)]
    for a, b in zip(sound, control):
        assert b["logit_rel_spread"]["value"] > 3 * a["logit_rel_spread"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVING + ["pix4point_vit_small.train_b64"])
def test_the_control_is_not_correct_at_the_cells_size(card, cell, tmp_path):
    out = tmp_path / "control.jsonl"
    run = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", cell,
                          "--seeds", "101,102,103", "--seconds", "2", "--variants", "control",
                          "--out", str(out)], cwd=ROOT, capture_output=True,
                         text=True, timeout=1800)
    assert run.returncode == 0, run.stderr[-3000:]
    config = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = json.loads((ROOT / "portbench" / "traffic" / f"{cell.split('.')[1]}.json")
                      .read_text())["kind"]
    limits = harness.limits_of(cell.split(".")[0], kind)
    for line in out.read_text().splitlines():
        row = json.loads(line)
        numbers = {k: v for k, v in row.items() if k in limits}
        assert numbers
        assert not check.judge(numbers, limits)[0], row
    assert config
