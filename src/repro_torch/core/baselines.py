"""Baseline configuration search spaces (paper §4.3, Table 1).

Every baseline is the SAME planner with feature flags — exactly how the
paper frames them:

* ``Unopt``  — no accuracy scaling, whole accelerators, static budgets.
* ``A``      — + model-variant accuracy scaling (INFaaS-style).
* ``S``      — + spatial partitioning (ParvaGPU-style).
* ``T``      — + task-graph-informed budgeting.
* ``A+T``    — ≈ Loki (Ahmad et al., 2024b).
* ``S+T``    — ≈ ParvaGPU+T.
* ``A+S``    — ≈ Clover+MPS (does not exist in prior work).
* ``A+S+T``  — JigsawServe.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.milp import FeatureSet

ANALYTICAL_BASELINES: Dict[str, FeatureSet] = {
    "Unopt": FeatureSet(False, False, False),
    "A": FeatureSet(True, False, False),
    "S": FeatureSet(False, True, False),
    "T": FeatureSet(False, False, True),
    "A+S": FeatureSet(True, True, False),
    "A+T": FeatureSet(True, False, True),
    "S+T": FeatureSet(False, True, True),
    "A+S+T": FeatureSet(True, True, True),
}

# paper §4.3: the empirical comparison runs the four best systems
EMPIRICAL_BASELINES: Dict[str, FeatureSet] = {
    "S+T": ANALYTICAL_BASELINES["S+T"],
    "A+T": ANALYTICAL_BASELINES["A+T"],
    "A+S": ANALYTICAL_BASELINES["A+S"],
    "JigsawServe": ANALYTICAL_BASELINES["A+S+T"],
}

PRIOR_WORK_EQUIV = {
    "A+T": "Loki (HPDC'24)",
    "S+T": "ParvaGPU+T (SC'24)",
    "A+S": "Clover+MPS (SC'23, strengthened)",
    "A+S+T": "JigsawServe (this paper)",
}
