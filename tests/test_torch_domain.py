"""PyTorch port, the lattice-domain decomposition (``parallel/domain.py``)
on 2 and 4 'space' ranks against JAX's ``make_domain_action`` on a mesh of
the same size (the virtual CPU devices of ``tests/conftest.py``) and
against JAX's replicated ``u1.wilson_action`` and its ``jax.grad``.

The ranks are spawned once per world size (``parallel/dryrun.spawn_local``,
gloo, ``file://`` rendezvous); the links are numpy draws from a seed.
Tolerances: those of JAX's ``tests/test_domain.py`` (action rtol 1e-5 with
atol 1e-4, gradients rtol 1e-4 with atol 1e-5, observables 1e-4): float32
sums over the shards in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu.parallel.domain import make_domain_action as j_domain
from l2hmc_tpu.parallel.mesh import get_mesh as j_mesh
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.parallel import dryrun
from l2hmc_tpu_torch.parallel import mesh as tmesh
from l2hmc_tpu_torch.parallel.domain import make_domain_action

torch.set_num_threads(1)

LT, LX, B = 16, 16, 4
WEIGHTS = np.arange(1.0, 5.0, dtype=np.float32)


def _links(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (B, LT, LX, 2)).astype(np.float32)


def _jax_numbers(links, n):
    """JAX's domain action on an n-way 'space' mesh, and the replicated
    action and its gradients."""
    mesh = j_mesh(num_data=1, num_space=n, devices=jax.devices()[:n])
    dom = j_domain(mesh, ju1.LatticeShape(LT, LX))
    sharded = jax.device_put(jnp.asarray(links),
                             NamedSharding(mesh, P(None, "space", None, None)))
    w = jnp.asarray(WEIGHTS)
    obs = jax.jit(dom["observables"])(sharded)
    rep = jnp.asarray(links)
    return {
        "action": np.asarray(jax.jit(dom["action"])(sharded)),
        "grad": np.asarray(jax.jit(jax.grad(
            lambda l: jnp.sum(dom["action"](l))))(sharded)),
        "wgrad": np.asarray(jax.jit(jax.grad(
            lambda l: jnp.sum(w * dom["action"](l))))(sharded)),
        **{k: np.asarray(v) for k, v in obs.items()},
    }, {
        "action": np.asarray(ju1.wilson_action(rep)),
        "grad": np.asarray(jax.grad(
            lambda l: jnp.sum(ju1.wilson_action(l)))(rep)),
        "wgrad": np.asarray(jax.grad(
            lambda l: jnp.sum(w * ju1.wilson_action(l)))(rep)),
        **{k: np.asarray(v) for k, v in ju1.observables(
            ju1.to_flat(rep), ju1.LatticeShape(LT, LX)).items()
           if k in ("actions", "plaqs", "charges")},
    }


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    n = request.param
    links = _links()
    got = dryrun.spawn_local(dryrun.domain_numbers, n, args=(
        torch.from_numpy(links), torch.from_numpy(WEIGHTS), "cpu", n))
    return n, links, got


def _check(got, want, keys=("action", "grad", "wgrad")):
    np.testing.assert_allclose(got["action"].numpy(), want["action"],
                               rtol=1e-5, atol=1e-4)
    for k in ("grad", "wgrad"):
        if k in keys:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_torch_domain_action_matches_jax(ranks):
    """Value, gradient and weighted gradient on n 'space' ranks (gathered
    back to the full lattice) against JAX's sharded action and its
    replicated Wilson action; every rank holds the same per-chain sums."""
    n, links, got = ranks
    want_sharded, want_rep = _jax_numbers(links, n)
    for r in got:
        _check(r, want_sharded)
        _check(r, want_rep)
        assert torch.equal(r["action"], got[0]["action"])
    assert got[0]["value"] == pytest.approx(float(want_rep["action"].sum()),
                                            rel=1e-5)


def test_torch_domain_observables_match_jax(ranks):
    n, links, got = ranks
    want_sharded, want_rep = _jax_numbers(links, n)
    for want in (want_sharded, want_rep):
        for k in ("actions", "plaqs", "charges"):
            np.testing.assert_allclose(got[0][k].numpy(), want[k],
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_torch_domain_action_without_a_group_wraps_locally():
    """One 'space' rank takes its halo from its own rows (no P2P): the
    domain action is the plain Wilson action and its gradient."""
    links = torch.from_numpy(_links(1))
    got = dryrun.domain_numbers(links, torch.from_numpy(WEIGHTS), "cpu", 1)
    lg = links.clone().requires_grad_(True)
    act = tu1.wilson_action(lg)
    (grad,) = torch.autograd.grad(torch.sum(act), lg)
    np.testing.assert_allclose(got["action"].numpy(), act.detach().numpy(),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["grad"].numpy(), grad.numpy(), atol=1e-5)


def test_torch_domain_refuses_an_uneven_time_split():
    three = tmesh.Mesh({"data": 1, "space": 3}, {"data": 0, "space": 0},
                       {"data": None, "space": None},
                       {"data": [0], "space": [0, 1, 2]},
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        make_domain_action(three, tu1.LatticeShape(16, 8))
