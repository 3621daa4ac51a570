"""The conv sampler's cell (``sample.conv16``) run whole on the CPU at a
small size, sound and with the timed path broken underneath: every fault
must come out as ``correct: false``.

The faults: a call that returns its state unchanged; half of the batch
left out (the other half's answers filled from it); one chain's first
accept probability altered where it is produced; the conditioner's dense
products (trunk and heads) taken with their operands rounded to TF32, the
precision below the configuration's; one bias or coefficient vector of one
net dropped in the program (a conv's, the trunk's, the heads', a
coefficient).  The size keeps the published widths
(16x16, filters 8/16, trunk 1024) with fewer chains and transitions: the
TF32 trunk still parts the readings by more than the limits there."""

import pytest
import torch

from bench_h100 import run
from bench_h100.lib import common
from bench_h100.reference.chains import tf32_round

CPU = torch.device("cpu")
SEED = 2 ** 40 + 9
SMALL = {"traffic": {"chains": 64, "transitions_per_call": 4}}
WORKLOAD = "sample.conv16"


def run_small():
    result, _ = run.run_cell(WORKLOAD, SEED, 0.3, 0, CPU, overrides=SMALL)
    return result


def unchanged(real):
    def make(cfg, n, *a, **k):
        chunk = real(cfg, n, *a, **k)

        def call(params, x, beta, gen):
            return (x,) + tuple(chunk(params, x, beta, gen)[1:])
        return call
    return make


def half_batch(real):
    """Only the first half of the chains computed; the second half keeps
    its links and copies the first half's traces."""
    def make(cfg, n, *a, **k):
        chunk = real(cfg, n, *a, **k)

        def call(params, x, beta, gen):
            h = x.shape[0] // 2
            xo, m = chunk(params, x[:h], beta, gen)
            return (torch.cat([xo, x[h:]]),
                    {key: torch.cat([t, t], dim=1) for key, t in m.items()})
        return call
    return make


def altered(real):
    """The first transition's accept probability of one chain moved by a
    half."""
    def make(cfg, n, *a, **k):
        chunk = real(cfg, n, *a, **k)

        def call(params, x, beta, gen):
            xo, m = chunk(params, x, beta, gen)
            prob = m["accept_prob"].clone()
            p = prob[0, 0]
            prob[0, 0] = p - 0.5 if p > 0.5 else p + 0.5
            return xo, {**m, "accept_prob": prob}
        return call
    return make


def test_sound_conv_run_is_correct():
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
def test_conv_call_fault_is_not_correct(fault, monkeypatch):
    from l2hmc_tpu_torch.train import gauge

    monkeypatch.setattr(gauge, "make_eval_chunk",
                        fault(gauge.make_eval_chunk))
    result = run_small()
    assert not result["correct"], result["checks"]


def test_tf32_trunk_is_not_correct(monkeypatch):
    from l2hmc_tpu_torch.networks import nets

    def tf32_matmul(x, w, bf16=False):
        return tf32_round(x) @ tf32_round(w)

    monkeypatch.setattr(nets, "matmul", tf32_matmul)
    result = run_small()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("net,leaf", [
    ("vnet", "conv_v1.b"), ("xnet", "h_layer.b"), ("vnet", "head_b"),
    ("xnet", "coeff_transformation")])
def test_conv_dropped_leaf_is_not_correct(net, leaf, monkeypatch):
    """The program's copy of one leaf zeroed after the drawn weights are
    loaded; the reference keeps it."""
    drv = common.load_module("drivers", "eval_chunk")
    real = drv.load_weights

    def load(params, nets, masks):
        real(params, nets, masks)
        with torch.no_grad():
            getattr(params, net).state_dict()[leaf].zero_()

    monkeypatch.setattr(drv, "load_weights", load)
    result = run_small()
    assert not result["correct"], result["checks"]
