"""One run of one cell: the parts every kind of traffic shares, and the
dispatch to the kind's own module.

Everything that belongs to a configuration, a traffic mix, a kind of
traffic or a metric is found by name: ``configs/<config>.json`` (through
``BENCHMARK.json``), ``traffic/<traffic>.json``, ``kinds/<kind>.py`` (the
traffic's ``kind``: its set-up, its loop and its check),
``reference/<name>.py`` (the plain reference and its work counts; the
configuration's ``reference``, by default its family),
``limits/<config>.<kind>.json`` and ``metrics/<metric>.py``. A run takes
from the program (``pointvit_tpu_torch``) only the system under test: the
model builder, the serving session, the trainer and the optimizer recipe
that the traffic names.

A kind frees the program's state before its reference runs, so the
reference never sets the run's memory peak, and hands the reference only
what the benchmark made: the weights (made again from the seed), the
clouds and the batches.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from portbench import generator, spans
from portbench.reference.layers import make_weights, no_tf32

__all__ = ["HERE", "load_cell", "run_cell", "context", "Context", "Trace", "reference_of",
           "kind_of", "limits_of", "reader", "program_model", "program_function"]

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: Path) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of workload ``name`` in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, _json(root / conf["file"]), _json(HERE / "traffic" / f"{cell['traffic']}.json")


def reference_of(family: str):
    return importlib.import_module(f"portbench.reference.{family}")


def kind_of(kind: str):
    """``kinds/<kind>.py``: ``run(ctx)`` and ``reading(ctx, variant)``."""
    return importlib.import_module(f"portbench.kinds.{kind}")


def limits_of(config: str, kind: str) -> dict:
    path = HERE / "limits" / f"{config}.{kind}.json"
    return _json(path)["limits"] if path.exists() else {}


def reader(metric: str):
    """``read(trace)`` of ``metrics/<metric>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_function(dotted: str):
    """The program's function ``"package.module:name"`` a traffic file names."""
    module, name = dotted.split(":")
    return getattr(importlib.import_module(module), name)


class Trace:
    """What a run hands the metric readers: ``kind``, ``family``, ``cfg``
    (the model's keys with ``points``), ``ref`` (the reference's module,
    with its work counts), ``batch``, ``window_s``,
    ``setup_s``, ``clouds``, ``steps``, ``latencies_ms`` and, in a traced
    run, ``spans`` (span → ms of each forward or step), ``request_host_ms``
    and ``device`` (:func:`spans.device_stretch`'s summary). A reader
    returns None where its field is missing."""

    def __init__(self, **kw) -> None:
        self.spans, self.request_host_ms, self.device = {}, [], None
        self.latencies_ms, self.clouds, self.steps, self.batch = [], 0, 0, None
        self.__dict__.update(kw)


def program_model(family: str, model_cfg: dict, weights: dict, device):
    """The program's model of ``family``, holding ``weights``."""
    from pointvit_tpu_torch.models.factory import build_model

    with torch.device(device):
        model = build_model(model_cfg, family)
    model.load_state_dict(weights, strict=True)
    return model


class Context:
    """One run's settings and the services its kind uses: the seeds, the
    reference, the weights, the traced stretch, the spans and the clock."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device, t_start,
                 program=None) -> None:
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace, self.t_start = seed, seconds, trace, t_start
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.family, self.kind = config["family"], traffic["kind"]
        self.model_cfg = dict(config["model"])
        self.cfg = {**self.model_cfg, "points": config["points"]}
        self.ref = reference_of(config.get("reference", self.family))
        # weights, inputs, order, the step's draws
        self.seeds = generator.derive_seeds(seed, 4)
        self.make_model = program or program_model
        self.marks_spec = config.get("marks", {}).get(self.kind)
        self._holder: dict = {}

    def trace_of(self, **kw) -> Trace:
        return Trace(kind=self.kind, family=self.family, cfg=self.cfg, ref=self.ref, **kw)

    def weights(self) -> dict:
        """The seeded weights, made anew on each call (on the device)."""
        return make_weights(self.ref.spec(self.cfg), self.seeds[0], self.device)

    def build_kernels(self) -> None:
        if self.cuda:
            from pointvit_tpu_torch import _build

            _build.build_kernels()

    def stretch(self):
        """The factory of the traced stretch a loop enters, or None."""
        if not (self.trace and self.cuda):
            return None
        spans.warm_profiler()

        def traced():
            self._holder["s"] = spans.device_stretch()
            return self._holder["s"]

        return traced

    def device_summary(self):
        return self._holder["s"].summary() if "s" in self._holder else None

    def marks(self, roots: dict):
        """The configuration's spans for this kind, in a traced run."""
        if not (self.trace and self.marks_spec):
            return None
        return spans.Marks(roots, self.marks_spec["marks"], self.marks_spec["spans"], self.cuda)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start_window(self) -> float:
        """Close set-up: drain the device, reset its peak, and return
        ``setup_s``."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        return time.time() - self.t_start

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    @staticmethod
    def free(state: dict) -> None:
        """Drop the program's objects and give their memory back."""
        state.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def context(cell, config, traffic, seed, seconds, trace, device, t_start,
            program=None) -> Context:
    no_tf32()
    return Context(cell, config, traffic, seed, seconds, trace, device, t_start, program)


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, program=None) -> dict:
    """One run; returns ``attempted``, ``failed``, ``errors``, ``trace``,
    ``peak`` and ``numbers`` (what the check compares). ``program`` (tests,
    the calibration) replaces the model the kind builds its system over: a
    callable ``program(family, model_cfg, weights, device)``."""
    ctx = context(cell, config, traffic, seed, seconds, trace, device, t_start, program)
    return kind_of(ctx.kind).run(ctx)
