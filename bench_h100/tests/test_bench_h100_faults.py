"""A whole run on the CPU at a small size (the look for a card skipped),
sound and with the timed path broken underneath: every fault a cell can
have must come out as ``correct: false``.

The faults: a step that returns its state unchanged; half of the batch
left out (the other half's answers filled from it); an answer altered
where it is produced, in the first transition of one chain or in a later
transition of a quarter of the chains.  The cells run on one card, so no
exchange between cards can be left out."""

import pytest
import torch

from bench_h100 import run

CPU = torch.device("cpu")
SEED = 2 ** 40 + 5
SMALL = {
    "sample.champion16": {"traffic": {"chains": 8,
                                      "transitions_per_call": 6}},
    "sample.hmc16": {"traffic": {"chains": 8, "transitions_per_call": 8}},
    "sample.local64": {"config": {"lattice": [8, 8]},
                       "traffic": {"chains": 8, "transitions_per_call": 6}},
}
ENTRY = {
    "sample.champion16": ("l2hmc_tpu_torch.ops.l2hmc_kernel", "l2hmc_chain"),
    "sample.hmc16": ("l2hmc_tpu_torch.ops.leapfrog", "hmc_chain"),
    "sample.local64": ("l2hmc_tpu_torch.ops.l2hmc_kernel",
                       "l2hmc_local_chain"),
}


def run_small(workload):
    result, _ = run.run_cell(workload, SEED, 0.3, 0, CPU,
                             overrides=SMALL[workload])
    return result


def unchanged(real):
    def chain(links, *a, **k):
        return (links,) + tuple(real(links, *a, **k)[1:])
    return chain


def half_batch(real):
    """Only the first half of the chains computed; the second half's
    answers copied from it."""
    def chain(links, *a, **k):
        h = links.shape[0] // 2
        if k.get("rand_arrays") is not None:
            k["rand_arrays"] = tuple(r[:, :h].contiguous()
                                     for r in k["rand_arrays"])
        out = real(links[:h], *a, **k)
        return (torch.cat([out[0], links[h:]]),) + tuple(
            torch.cat([t, t], dim=1) for t in out[1:])
    return chain


def altered(real):
    """One answer altered where it is produced: the first transition's
    accept probability of one chain, moved by a half."""
    def chain(links, *a, **k):
        out = real(links, *a, **k)
        prob = out[3].clone()
        p = prob[0, 0]
        prob[0, 0] = p - 0.5 if p > 0.5 else p + 0.5
        return tuple(out[:3]) + (prob,)
    return chain


def later_chains(real):
    """An answer altered in a later transition of a quarter of the chains
    (every fourth): their third transition's accept probability moved by
    a half."""
    def chain(links, *a, **k):
        out = real(links, *a, **k)
        prob = out[3].clone()
        p = prob[2, ::4]
        prob[2, ::4] = torch.where(p > 0.5, p - 0.5, p + 0.5)
        return tuple(out[:3]) + (prob,)
    return chain


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    result = run_small(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   later_chains], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_chain_fault_is_not_correct(workload, fault, monkeypatch):
    import importlib

    mod_name, fn = ENTRY[workload]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, fn, fault(getattr(mod, fn)))
    result = run_small(workload)
    assert not result["correct"], result["checks"]
