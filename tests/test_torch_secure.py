"""Secure aggregation in the port: ``tests/test_secure_http.py``'s cases
against ``baton_tpu_torch/server/secure.py`` and the port's HTTP pair on
the CPU, the offline primitive's cases of ``tests/test_privacy.py``
against ``baton_tpu_torch/ops/secure_agg.py``, and a secure round run
across the packages.

The protocol's masks, DH group and Shamir shares are pure Python and
numpy, so a torch worker's masks cancel under a JAX manager and the other
way round: such a round equals the JAX pair's within 1e-5.
"""

import functools

import numpy as np
import pytest

import _torch_cpu
from _torch_carried_cases import port_cases
from _torch_sockets import SOCKET_SEAMS, reserve_port, run_bounded, tcp_site
from baton_tpu_torch.ops.secure_agg import (
    aggregate_masked,
    dequantize,
    mask_update,
    net_mask_of,
    quantize,
)
from test_torch_http_parity import TOL, _max_gap, federation

globals().update(port_cases(
    "test_secure_http.py",
    {"test_secure_round_64_cohort_scaling":
         "a 64-member cohort takes ~50 s on a CPU, and this file must stay "
         "under a minute; the 16-member case runs the same code with faults"},
    seams=(
        _torch_cpu.SEAMS["Manager"],
        _torch_cpu.SEAMS["ExperimentWorker"],
        *SOCKET_SEAMS,  # servers on sockets bound before use
        # every socket case under its own wall-clock limit
        ("def run(coro):\n    return asyncio.run(coro)",
         "def run(coro):\n    return run_bounded(lambda: coro)"),
    ),
    extra_globals={"run_bounded": run_bounded, "reserve_port": reserve_port,
                   "tcp_site": tcp_site},
))


# ----------------------------------------------------------------------
# tests/test_privacy.py's secure-aggregation cases; the seed is an int
# where the reference passes a JAX key


def _rand_tree(nprng, scale=1.0):
    return {
        "w": (nprng.normal(size=(3, 4)) * scale).astype(np.float32),
        "b": (nprng.normal(size=(4,)) * scale).astype(np.float32),
    }


def _plain_sum(updates):
    return {k: sum(np.asarray(u[k], np.float64) for u in updates) for k in updates[0]}


def test_quantize_roundtrip(nprng):
    t = _rand_tree(nprng)
    rt = dequantize(quantize(t))
    for k in t:
        np.testing.assert_allclose(rt[k], t[k], atol=2e-5)


def test_secure_agg_sum_matches_plain_sum(nprng):
    n = 5
    seed = 7
    updates = [_rand_tree(nprng) for _ in range(n)]
    masked = [mask_update(u, seed, i, n) for i, u in enumerate(updates)]
    # any single masked update is garbage to the server (uniform ring
    # noise): it must differ wildly from its own quantized plaintext
    delta = np.abs(dequantize(masked[0])["w"] - np.asarray(updates[0]["w"], np.float64))
    assert delta.max() > 100.0
    out = aggregate_masked(masked)
    plain = _plain_sum(updates)
    for k in plain:
        np.testing.assert_allclose(out[k], plain[k], atol=1e-4)


def test_secure_agg_dropout_recovery(nprng):
    n = 4
    seed = 3
    updates = [_rand_tree(nprng) for _ in range(n)]
    masked = [mask_update(u, seed, i, n) for i, u in enumerate(updates)]
    # client 2 drops after masking: survivors' sum is polluted by its
    # uncancelled pairwise masks until the server adds net_mask_of(2)
    survivors = [masked[i] for i in (0, 1, 3)]
    recovered = aggregate_masked(
        survivors, dropped_net_masks=[net_mask_of(seed, 2, n, quantize(updates[2]))])
    plain = _plain_sum([updates[i] for i in (0, 1, 3)])
    for k in plain:
        np.testing.assert_allclose(recovered[k], plain[k], atol=1e-4)


def test_secure_agg_without_recovery_is_garbage(nprng):
    n = 3
    seed = 9
    updates = [_rand_tree(nprng) for _ in range(n)]
    masked = [mask_update(u, seed, i, n) for i, u in enumerate(updates)]
    broken = aggregate_masked(masked[:2])  # client 2's masks uncancelled
    diff = np.abs(broken["w"] - _plain_sum(updates[:2])["w"])
    assert diff.max() > 100.0


def test_pair_masks_depend_on_the_seed_and_pair_only(nprng):
    """A pair's mask is the same whichever member draws it, and another
    seed or pair draws another one."""
    template = quantize(_rand_tree(nprng))
    m01 = net_mask_of(5, 0, 2, template)
    m10 = net_mask_of(5, 1, 2, template)
    for k in template:
        assert np.array_equal((m01[k] + m10[k]).astype(np.uint32), np.zeros_like(m01[k]))
    assert not np.array_equal(net_mask_of(6, 0, 2, template)["w"], m01["w"])
    assert not np.array_equal(net_mask_of(5, 0, 3, template)["w"], m01["w"])


# ----------------------------------------------------------------------
# a secure round across the packages


@functools.lru_cache(maxsize=None)
def _jax_pair_secure_round():
    return federation("linear", "jax", ["jax"] * 3, secure_agg=True)


@pytest.mark.parametrize("manager_pkg,worker_pkgs", [
    ("torch", ["torch"] * 3),
    ("jax", ["torch"] * 3),
    ("torch", ["jax"] * 3),
], ids=["torch-pair", "jax-manager-torch-workers", "torch-manager-jax-workers"])
def test_secure_round_matches_the_jax_pair(manager_pkg, worker_pkgs):
    want = _jax_pair_secure_round()
    got = federation("linear", manager_pkg, worker_pkgs, secure_agg=True)
    plain = federation("linear", manager_pkg, worker_pkgs)
    assert _max_gap(got, want) <= TOL
    # the secure round is the plain round to the fixed-point quantum
    assert _max_gap(got, plain) <= TOL
