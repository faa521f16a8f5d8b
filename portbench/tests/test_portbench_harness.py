"""Guards of the harness: what a run imports, that cells, traffic and
metrics are found by name, and that a run without a card gives no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import HERE, ROOT

SCAN = """
import importlib, importlib.util, json, sys
from pathlib import Path
import portbench.run, portbench.harness, portbench.calibrate
here = Path(portbench.run.__file__).parent
for f in sorted((here / "kinds").glob("*.py")):
    importlib.import_module("portbench.kinds." + f.stem)
for kind in ("configs", "traffic"):
    for f in sorted((here / kind).glob("*.json")):
        json.loads(f.read_text())
for f in sorted((here / "metrics").glob("*.py")):
    portbench.harness.reader(f.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, **(env or {})}, timeout=600)


def test_a_run_imports_nothing_of_jax_or_the_jax_package():
    out = _python(SCAN)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "pointvit_tpu"}, tops  # pointvit_tpu_torch may


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib, portbench.reference as r\n"
            "[importlib.import_module('portbench.reference.' + m.name) "
            "for m in pkgutil.iter_modules(r.__path__)]\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = out.stdout
    for name in ("'pointvit_tpu_torch'", "'pointvit_tpu'", "'jax'", "'flax'"):
        assert name not in tops
    for f in (HERE / "reference").glob("*.py"):
        text = f.read_text()
        assert "import pointvit" not in text and "from pointvit" not in text, f


def test_a_run_without_a_card_exits_without_a_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "apf_slim2.serve_b256", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in bench["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


ADDED = """
import json, sys, time
from pathlib import Path
from portbench import harness, run
bench = json.loads(Path("BENCHMARK.json").read_text())
cell, config, traffic = harness.load_cell(bench, "tiny_apf.tiny_batch", Path("."))
out = harness.run_cell(cell, config, traffic, 2**31 + 99, 0.5, True, "cpu", time.time())
print(json.dumps(run.metric_values(bench, "tiny_apf.tiny_batch", True, out["trace"])))
"""


def test_added_files_are_found_by_name(tmp_path):
    from conftest import tiny

    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config, traffic = tiny("apf_slim2", "serve_b256")
    config["name"] = "tiny_apf"
    traffic["kind"] = "tiny_kind"  # a kind of traffic of its own, found by name too
    config["marks"]["tiny_kind"] = config["marks"].pop("batch")
    (root / "portbench" / "kinds" / "tiny_kind.py").write_text(
        "from portbench.kinds.batch import VARIANTS, reading, run  # noqa: F401\n")
    (root / "portbench" / "configs" / "tiny_apf.json").write_text(json.dumps(config))
    (root / "portbench" / "traffic" / "tiny_batch.json").write_text(json.dumps(traffic))
    (root / "portbench" / "metrics" / "tiny_answers.py").write_text(
        "def read(t):\n    return t.clouds if t.kind == 'tiny_kind' and t.spans else None\n")
    bench["configs"].append({"name": "tiny_apf", "source": "a test", "why": "a test",
                             "file": "portbench/configs/tiny_apf.json", "reduced": []})
    bench["workloads"].append({"name": "tiny_apf.tiny_batch", "config": "tiny_apf",
                               "traffic": "tiny_batch", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiny_answers", "unit": "clouds", "better": "higher",
                               "source": "host_clock", "layer": "a test", "moves": "setup_s",
                               "workloads": ["tiny_apf.tiny_batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(ADDED, cwd=root, env={"PYTHONPATH": f"{root}{os.pathsep}{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["tiny_answers"]["value"] > 0
    assert set(metrics) == {"tiny_answers"}  # the others list their own cells


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card, tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "apf_slim2.serve_b256", "--seed", str(2**31 + 17), "--seconds", "3",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
