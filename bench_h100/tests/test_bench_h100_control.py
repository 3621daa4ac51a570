"""Each cell's control, at a size a test run holds: the plain reference in
the next precision below the configuration's (TF32 products for the
trained samplers, bfloat16 arithmetic for HMC) put in
the program's place, judged as the program is, must come out not correct
against the cell's limits.  The readings at each cell's own size, on the
card, are ``control.py``'s (PERF.md)."""

from types import SimpleNamespace

import pytest
import torch

from bench_h100.lib import common
from bench_h100.reference import chains, judge

# fewer chains than the cells' and short calls: the largest first-transition
# gaps and the bulk's drift still clear the limits (the local sampler's
# first-transition gap needs some hundred chains to show its tail)
SIZES = {
    "sample.champion16": {"traffic": {"chains": 256,
                                      "transitions_per_call": 40}},
    "sample.hmc16": {"traffic": {"chains": 16, "transitions_per_call": 20}},
    "sample.local64": {"traffic": {"chains": 128,
                                   "transitions_per_call": 12}},
}


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_is_not_correct(workload):
    spec = common.load_json("workloads", workload)
    over = SIZES[workload]
    config = {**common.load_json("configs", spec["config"]),
              **over.get("config", {})}
    traffic = {**common.load_json("traffic", spec["traffic"]),
               **over.get("traffic", {})}
    ctx = SimpleNamespace(workload=workload, seed=2 ** 35 + 11,
                          device=torch.device("cpu"), config=config,
                          traffic=traffic)
    cell = common.load_module("drivers", traffic["driver"]).Cell(ctx)
    cell.setup()
    limits = spec["limits"]
    values = cell.control(limits, chains.Precision(spec["control"]))
    assert not judge.correct(judge.with_limits(values, limits)), values
