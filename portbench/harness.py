"""One run of one cell: find its files by name, run its driver, read its
metrics, judge ``correct`` and assemble the result line.

Everything of one cell is found by name from ``BENCHMARK.json``:

* ``portbench/configs/<file>``       the configuration (the entry's ``file``);
* ``portbench/traffic/<mix>.json``   the traffic mix; its ``kind`` names
  the driver, ``portbench/drivers/<kind>.py``;
* ``portbench/limits/<cell>.json``   the limit of each number ``correct``
  compares;
* ``portbench/metrics/<metric>.py``  one reader a metric, end to end or
  per layer: ``read(run) -> float or None``;
* ``portbench/arch/<model_type>.py`` one file a model family, found by the
  configuration's Hugging Face ``model_type``: its builder, seeded-weight
  layout, plain reference and work counts (``FAMILY_API``).

A cell that adds only files of these kinds and entries in
``BENCHMARK.json`` runs without an edit to any file here.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what a family file gives, and all the benchmark uses of it:
# build(cfg, seed, device) -> the port's model holding the seeded weights;
# layout(cfg) -> [(name, shape, std)] in stream order;
# logits(cfg, weight, seqs, rows, quant=None) -> the plain fp32 reference;
# sequence_flops(cfg, prompt_len, new_tokens) -> one request's model FLOPs;
# kernel_work(cfg, B, S, new_tokens) -> {kernel: [(FLOPs, bytes), ...]}
FAMILY_API = ("build", "layout", "logits", "sequence_flops", "kernel_work")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in list(sys.modules)
                  if n.partition(".")[0] in FORBIDDEN)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Check:
    """One number that ``correct`` compares, with its limit (the number
    must not exceed it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (not math.isnan(self.value)) and self.value <= self.limit


@dataclass
class Run:
    """What one run of a cell recorded; the metric readers read it."""
    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    control: bool = False           # judge the fp8 control (control.py)
    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    requests: List[dict] = field(default_factory=list)
    batches: List[dict] = field(default_factory=list)
    hops: List[dict] = field(default_factory=list)
    spans: List[Any] = field(default_factory=list)
    counters: Dict[str, Any] = field(default_factory=dict)
    model_flops: float = 0.0        # model FLOPs served in ``model_s``
    model_s: float = math.nan
    traced_work: Dict[str, list] = field(default_factory=dict)
    device_trace: Any = None
    checks: List[Check] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    notes: Dict[str, Any] = field(default_factory=dict)
    families: Dict[str, Any] = field(default_factory=dict)

    def family(self, model_cfg: dict):
        """The family file of a model configuration (its ``model_type``),
        loaded once a run."""
        if "model_type" not in model_cfg:
            raise KeyError(f"the configuration {model_cfg.get('name')!r} "
                           f"states no model_type")
        t = model_cfg["model_type"]
        if t not in self.families:
            self.families[t] = family(self.root, t)
        return self.families[t]

    @property
    def on_cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.on_cuda:
            import torch
            torch.cuda.synchronize()

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def check(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r} in the cell's limits file")
        self.checks.append(Check(name, float(value), float(self.limits[name])))

    def check_served(self, name: str, got: dict) -> None:
        """Judge a served model's widest logit gap
        (``reference.judged_sequences``) by its limit.  In a control run
        the control is put in the program's place: the tokens it puts first
        are judged by the same limit, and the program's own reading is
        kept as a note."""
        if self.control:
            self.notes[f"program.{name}"] = got["gap"]
            self.check(name, got["control_gap"])
        else:
            self.check(name, got["gap"])

    def judge_served(self, name: str, model_cfg: dict, seed: int,
                     cases: list) -> dict:
        """Judge the served ``cases`` of one model by its family's plain
        reference, on weights made again from ``seed`` (the program's
        state is freed first), and free them after."""
        from portbench import reference, weights
        fam = self.family(model_cfg)
        weight = weights.all_weights(fam.layout(model_cfg), seed,
                                     self.device,
                                     weights.served_dtype(model_cfg))
        got = reference.judged_sequences(fam, model_cfg, weight.__getitem__,
                                         cases, self.control, self.device)
        self.check_served(name, got)
        del weight
        self.free()
        return got

    def fail(self, why: str) -> None:
        """A fault that makes the run not correct, whatever the numbers."""
        self.errors.append(why)

    def read_peak(self) -> None:
        if self.on_cuda:
            import torch
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        gc.collect()
        if self.on_cuda:
            import torch
            torch.cuda.empty_cache()


def metric_entries(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` its per-layer
    metrics, else its end-to-end ones.  A metric with ``workloads`` is
    reported in those cells; a per-layer one without it wherever its
    ``moves`` metric is, an end-to-end one without it everywhere."""
    e2e = spec["end_to_end"]
    mine = {m["name"] for m in e2e
            if "workloads" not in m or cell in m["workloads"]}
    if not trace:
        return [m for m in e2e if m["name"] in mine]
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def _load(path: Path, prefix: str):
    """The module of the file ``path``, loaded by its path."""
    mod_spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    return _load(root / "portbench" / "metrics" / f"{name}.py",
                 "portbench_metric_").read


def family(root: Path, model_type: str):
    """The family file ``portbench/arch/<model_type>.py``, loaded by its
    path; it must give every function of ``FAMILY_API``."""
    if not isinstance(model_type, str) or not NAME.fullmatch(model_type):
        raise ValueError(f"not a model_type: {model_type!r}")
    path = root / "portbench" / "arch" / f"{model_type}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no family file for model_type "
                                f"{model_type!r}: looked for {path}")
    mod = _load(path, "portbench_arch_")
    missing = [f for f in FAMILY_API if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"{path} lacks {missing}")
    return mod


def prepare(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str, t_start: float) -> Run:
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(root / configs[cell["config"]]["file"])
    traffic = _read_json(root / "portbench" / "traffic"
                         / f"{cell['traffic']}.json")
    limits = _read_json(root / "portbench" / "limits" / f"{workload}.json")
    return Run(root, cell, config, traffic, limits, seed, seconds, trace,
               device, t_start)


def execute(run: Run) -> None:
    """Run the cell's driver (set-up, window, judgement)."""
    driver = importlib.import_module(f"portbench.drivers.{run.traffic['kind']}")
    driver.run(run)


def judged_correct(run: Run) -> bool:
    """No fault, at least one number compared, and each within its limit."""
    return not run.errors and bool(run.checks) and all(c.ok for c in run.checks)


def result(run: Run, spec: dict, device_info: dict) -> dict:
    """The result line: ``correct``, counts, the cell's metrics, the device
    and, last, each compared number beside its limit."""
    metrics = {}
    for m in metric_entries(spec, run.cell["name"], run.trace):
        value = reader(run.root, m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": judged_correct(run),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    tr = run.device_trace
    if run.trace and tr is not None and tr.busy_s is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    if run.errors:
        out["checks"]["faults"] = {"value": len(run.errors), "limit": 0}
    return out


def report_checks(run: Run, stream=sys.stderr) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for why in run.errors:
        print(f"fault: {why}", file=stream)
    for c in run.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=stream)
    stream.flush()


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile, or None without values."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(math.ceil(q / 100.0 * len(xs)) - 1, 0)]
