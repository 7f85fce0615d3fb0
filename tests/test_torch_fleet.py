"""Port parity for the serve fleet (qwen3-8b SMOKE, CPU).

The port's ``ServeFleet`` / ``Router`` / ``AsyncFrontend``
(``repro_torch.serve.fleet``) against the reference's
(``repro.serve.fleet``):

* the routers' picks and ``by_depth`` on stub engines fed seeded loads
  and match depths, every policy at two ``balance_slack`` values;
* the configs, device groups and device counts they refuse;
* the reference's own fleet setup (``tests/test_fleet.py``: 2:8 bdwp
  masked weights, 2 slots, bucket 12, its seed-11 prompts, the weights
  carried across by ``convert``): one trace through a colocated
  ``prefix`` fleet and a disaggregated one gives each request the
  reference's stream, replica, prefix hit and finish step, and
  ``stats()`` the reference's, exactly;
* the port's packed fleet (one ``PackedParamStore`` shared by every
  engine; the plain paths on the CPU) and ``AsyncFrontend`` give the
  streams of the port's solo packed engine.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.launch import spmd as JSPMD
from repro.models import transformer_lm as JT
from repro.serve import FleetConfig as JFleetConfig
from repro.serve import Router as JRouter
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeFleet as JServeFleet
from repro_torch import convert
from repro_torch.configs import qwen3_8b as TC
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.launch import spmd
from repro_torch.serve import (AsyncFrontend, FleetConfig, Router,
                               ServeFleet)
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.fleet import ROUTERS
from repro_torch.serve.packed_params import PackedParamStore

jax.config.update("jax_platform_name", "cpu")

J_CFG = get_arch("qwen3-8b").smoke
T_CFG = TC.SMOKE
J_SP = JSparsity(n=2, m=8, method="bdwp")
T_SP = SparsityConfig(n=2, m=8, method="bdwp")
SERVE = dict(n_slots=2, max_len=32, prompt_bucket=12)
MAX_NEW = 6
LENS = (4, 8, 6)
CPU2 = ["cpu", "cpu"]
TRACE, TRACE_NEW = (0, 1, 2, 0, 1, 1), (MAX_NEW,) * 5 + (1,)


@pytest.fixture(scope="module")
def jparams():
    p, _ = JT.init(jax.random.PRNGKey(0), J_CFG)
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), p)


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


@pytest.fixture(scope="module")
def prompts():
    """The reference fleet test's prompts (``tests/test_fleet.py``)."""
    key = jax.random.PRNGKey(11)
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                          (n,), 0, J_CFG.vocab))
            for i, n in enumerate(LENS)]


@pytest.fixture(scope="module")
def trace(prompts):
    """Six requests: repeats for the prefix pools, and one that ends on
    its first token (a disaggregated fleet finishes it at prefill)."""
    return [(prompts[i], m) for i, m in zip(TRACE, TRACE_NEW)]


@pytest.fixture(scope="module")
def store(tparams):
    return PackedParamStore.pack(tparams, T_SP, idx_bits=4, device="cpu")


@pytest.fixture(scope="module")
def solo_packed(store, prompts):
    """Each prompt decoded alone on one packed engine of the port."""
    eng = ServeEngine(store, T_CFG, T_SP, ServeConfig(packed=True, **SERVE),
                      device="cpu")
    out = []
    for p in prompts:
        rid = eng.submit(p, max_new_tokens=MAX_NEW)
        out.append(eng.run()[rid])
        eng.reset()
    return out


# -- the router on stub engines ---------------------------------------------


class StubEngine:
    def __init__(self, depth, running, queued, n_slots):
        self.depth, self.running, self.queued, self.n_slots = (
            depth, running, queued, n_slots)

    def prefix_match_depth(self, chain):
        return self.depth

    def utilization(self):
        return {"n_slots": self.n_slots, "running": self.running,
                "queued": self.queued, "free_slots": 0,
                "load": (self.running + self.queued) / self.n_slots}


@pytest.mark.parametrize("slack", [0, 2])
@pytest.mark.parametrize("policy", ROUTERS)
def test_router_picks_match_reference(policy, slack):
    rng = np.random.default_rng(7)
    ours, ref = (Router(policy, seed=3, balance_slack=slack),
                 JRouter(policy, seed=3, balance_slack=slack))
    picks, want = [], []
    for _ in range(300):
        n = int(rng.integers(1, 5))
        n_slots = int(rng.integers(1, 5))
        engines = [StubEngine(int(rng.integers(0, 3)),
                              int(rng.integers(0, n_slots + 1)),
                              int(rng.integers(0, 3 * n_slots)), n_slots)
                   for _ in range(n)]
        chain = ("a", "b", "c")[:int(rng.integers(0, 4))]
        picks.append(ours.choose(engines, chain))
        want.append(ref.choose(engines, chain))
    assert picks == want
    assert ours.by_depth == ref.by_depth
    assert len(set(picks)) > 1


# -- what both refuse --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_replicas=0), dict(n_replicas=-1), dict(router="round_robin"),
    dict(disaggregate=True, n_prefill=0), dict(n_prefill=0),
    dict(n_replicas=3, router="random", disaggregate=True, n_prefill=2)])
def test_fleet_config_validation_matches_reference(kw):
    def outcome(cls):
        try:
            cls(**kw)
        except ValueError:
            return "ValueError"
        return "ok"

    assert outcome(FleetConfig) == outcome(JFleetConfig)


def test_replica_device_groups_match_reference():
    for n_dev in range(0, 9):
        devs = list(range(n_dev))
        for n in range(-1, 10):
            try:
                want = JSPMD.replica_device_groups(n, devices=devs)
            except ValueError:
                with pytest.raises(ValueError):
                    spmd.replica_device_groups(n, devices=devs)
                continue
            assert spmd.replica_device_groups(n, devices=devs) == want


def test_fleet_meshes_one_device_a_replica():
    assert spmd.fleet_meshes(2, devices=CPU2) == [torch.device("cpu")] * 2
    with pytest.raises(NotImplementedError, match="item 7"):
        spmd.fleet_meshes(1, devices=CPU2)
    with pytest.raises(ValueError):       # one card: no two groups
        spmd.fleet_meshes(2, devices=["cpu"])
    assert spmd.fleet_meshes(4, devices=CPU2 * 2) == [torch.device("cpu")] * 4


def test_device_count_and_store_device_rejected(tparams, store):
    serve = ServeConfig(packed=True, **SERVE)
    with pytest.raises(ValueError, match="1 devices for 2 replicas"):
        ServeFleet(tparams, T_CFG, T_SP, serve, FleetConfig(n_replicas=2),
                   devices=["cpu"])
    with pytest.raises(ValueError, match="PackedParamStore lies on cpu"):
        ServeFleet(store, T_CFG, T_SP, serve, FleetConfig(n_replicas=2),
                   devices=["meta", "meta"])


# -- the fleet against the reference fleet -----------------------------------


def _drive(fleet, trace):
    """Submit the trace, step until drained; per request (stream,
    replica, prefix hit, finish step), and the fleet's stats."""
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in trace]
    while fleet.n_pending:
        fleet.step()
    done = {r.rid: (r.tokens, r.replica, r.prefix_hit, r.finish_step)
            for r in fleet.finished_requests}
    assert sorted(fleet.harvest()) == sorted(rids)
    return [done[r] for r in rids], fleet.stats()


FLEETS = {"colocated": dict(n_replicas=2, router="prefix"),
          "disaggregated": dict(n_replicas=2, router="prefix",
                                disaggregate=True, n_prefill=1)}


@pytest.mark.parametrize("mode", list(FLEETS))
def test_fleet_matches_reference_fleet(jparams, tparams, trace, mode):
    want, want_st = _drive(
        JServeFleet(jparams, J_CFG, J_SP, JServeConfig(**SERVE),
                    JFleetConfig(**FLEETS[mode])), trace)
    got, got_st = _drive(
        ServeFleet(tparams, T_CFG, T_SP, ServeConfig(**SERVE),
                   FleetConfig(**FLEETS[mode]), device="cpu"), trace)
    assert got == want
    assert got_st == want_st
    assert any(hit for _, _, hit, _ in got)
    if mode == "colocated":
        assert sum(n for d, n in got_st["routed_by_depth"].items() if d)
    else:
        assert all(e["prefill_steps"] == 0 for e in got_st["engines"])
        assert got_st["store"]["size"] == 0
        assert got[-1][1] is None          # finished at prefill


# -- the port's packed fleet and the async frontend --------------------------


@pytest.mark.parametrize("fleet_kw", [
    dict(router="prefix"), dict(router="least_loaded"),
    dict(router="random", route_seed=5),
    dict(router="prefix", disaggregate=True)])
def test_packed_fleet_matches_solo_engine(store, trace, solo_packed,
                                          fleet_kw):
    fleet = ServeFleet(store, T_CFG, T_SP, ServeConfig(packed=True, **SERVE),
                       FleetConfig(n_replicas=2, **fleet_kw), devices=CPU2,
                       device="cpu")
    assert all(e.store is store for e in fleet.engines
               + fleet.prefill_engines)
    got, st = _drive(fleet, trace)
    assert [g[0] for g in got] == [
        solo_packed[i][:m] for i, m in zip(TRACE, TRACE_NEW)]
    assert all(e["decode_steps"] > 0 for e in st["engines"])


def test_dense_tree_is_packed_once_per_device(tparams):
    fleet = ServeFleet(tparams, T_CFG, T_SP, ServeConfig(packed=True,
                                                         **SERVE),
                       FleetConfig(n_replicas=2, disaggregate=True),
                       device="cpu")
    stores = {id(e.store) for e in fleet.engines + fleet.prefill_engines}
    assert len(stores) == 1


def test_async_frontend_matches_solo(store, prompts, solo_packed):
    serve = ServeConfig(packed=True, **SERVE)

    async def concurrent():
        fr = AsyncFrontend(ServeFleet(store, T_CFG, T_SP, serve,
                                      FleetConfig(n_replicas=2),
                                      device="cpu"))
        return await asyncio.gather(
            *[fr.generate(p, max_new_tokens=MAX_NEW) for p in prompts])

    async def late_joiner():
        fr = AsyncFrontend(ServeFleet(store, T_CFG, T_SP, serve,
                                      FleetConfig(n_replicas=1),
                                      device="cpu"))
        first = asyncio.create_task(
            fr.generate(prompts[0], max_new_tokens=MAX_NEW))
        await asyncio.sleep(0)       # the driver runs, the queue drained
        second = await fr.generate(prompts[1], max_new_tokens=MAX_NEW)
        return await first, second

    assert [list(o) for o in asyncio.run(concurrent())] == solo_packed
    a, b = asyncio.run(late_joiner())
    assert [list(a), list(b)] == solo_packed[:2]
