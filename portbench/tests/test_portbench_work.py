"""The work counts of ``portbench/work.py`` against numbers worked by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import work
from portbench.harness import reference_of

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_apf_block_by_hand():
    # S 196, E 768, adapter 64: qkv 2·196·768·2304 = 693,633,024; the two
    # attention products 2·(2·196·196·768) = 118,013,952; proj 2·196·768² =
    # 231,211,008; fc1 + fc2 2·(2·196·768·3072) = 1,849,688,064; the
    # adapter's down and up 2·(2·196·768·64) = 38,535,168.
    assert work.apf_block_flops(196, 768, 64) == 2_931_081_216


def test_vit_block_by_hand():
    # S 513, E 384: qkv 453,869,568; attention 404,227,584; proj
    # 151,289,856; MLP (1536) 1,210,318,848.
    assert work.vit_block_flops(513, 384) == 2_219_705_856


def test_p3_stage_by_hand():
    # 512 groups of 16 rows: 6→256 25,165,824; 256→256 1,073,741,824;
    # 512→512 4,294,967,296; 512→256 2,147,483,648.
    assert work.p3_stage_flops(512, 16) == 7_541_358_592


def test_encoder_by_hand():
    # slim2: 196 groups of 16 rows (3,136), 6→256→512→768, the global half
    # once a group (768→384), the local half a row (768→384), 384→768.
    rows = 196 * 16
    want = 2 * rows * (6 * 256 + 256 * 512 + 512 * 768 + 768 * 384 + 384 * 768) + 2 * 196 * 768 * 384
    assert work.encoder_flops(196, 16, 6, 768, 384) == want == 7_112_949_760


@pytest.mark.parametrize("name,family,lo,hi", [("apf_slim2", "apf", 42.0e9, 42.7e9),
                                               ("pix4point_vit_small", "pix4point", 34.0e9, 34.6e9)])
def test_forward_flops_of_the_cells(name, family, lo, hi):
    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg = {**conf["model"], "points": conf["points"]}
    assert lo < reference_of(family).forward_flops(cfg) < hi


def test_bound_takes_the_longer():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
    # FPS: 10 operations a point and step at 33.5 TFLOP/s
    assert work.fps_bound_s(256, 2048, 512) == pytest.approx(10 * 256 * 2048 * 512 / 33.5e12)
