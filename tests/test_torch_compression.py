"""Update compression in the port (``baton_tpu_torch/ops/compression.py``):
``tests/test_compression.py``'s cases against it and the port's HTTP pair
on the CPU, with the reference's tolerances, and parity with the JAX
package on identical numpy inputs.

Parity is exact where the arithmetic is: on inputs with no ties in
magnitude, ``topk_compress`` keeps the index set of ``jax.lax.top_k`` in
its order, with values and residual equal to the bit, and both
decompressions agree exactly. ``quantize_stochastic``'s scale equals JAX's
to the bit; its draws come from a ``torch.Generator``, so each ``q`` is
held to {floor(y), floor(y) + 1}. The numpy downlink half is the
reference's code, so its encoded blobs are byte-equal across the packages.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_cpu
from _torch_carried_cases import port_cases
from _torch_sockets import SOCKET_SEAMS, reserve_port, run_bounded, tcp_site
from baton_tpu.ops import compression as jcomp
from baton_tpu.server import wire as jwire
from baton_tpu_torch.ops import compression as tcomp
from baton_tpu_torch.server import wire

torch.set_num_threads(1)

globals().update(port_cases(
    "test_compression.py", {},
    seams=(
        _torch_cpu.SEAMS["Manager"],
        _torch_cpu.SEAMS["ExperimentWorker"],
        _torch_cpu.SEAMS["FedSim"],
        _torch_cpu.SEAMS["state_dict_to_params"],
        # the port's quantizer draws from a torch.Generator, not a JAX key
        ("quantize_stochastic(x, jax.random.key(i), bits=8)",
         "quantize_stochastic(x, torch.Generator().manual_seed(i), bits=8)"),
        # the port's simulated cohort takes torch tensors
        ("data = {k: jnp.asarray(v) for k, v in data.items()}\n\n        app",
         "data = {k: torch.as_tensor(v) for k, v in data.items()}\n\n        app"),
        *SOCKET_SEAMS,  # servers on sockets bound before use
        # every socket case under its own wall-clock limit
        ("asyncio.run(main())", "run_bounded(main)"),
    ),
    extra_globals={"run_bounded": run_bounded, "reserve_port": reserve_port,
                   "tcp_site": tcp_site, "torch": torch},
))


# ----------------------------------------------------------------------
# parity with the JAX package


def _tie_free(rng, shape):
    """Values with distinct magnitudes in (0, 1] and random signs (no tie
    for top-k to break)."""
    n = int(np.prod(shape))
    mags = rng.permutation(np.arange(1, n + 1, dtype=np.float32)) / n
    return (mags * rng.choice([-1.0, 1.0], size=n).astype(np.float32)).reshape(shape)


def _tree(rng):
    return {"conv/w": _tie_free(rng, (3, 3, 4, 8)), "dense/b": _tie_free(rng, (17,))}


@pytest.mark.parametrize("frac", [0.05, 0.3, 1.0])
def test_topk_compress_equals_the_jax_package_to_the_bit(frac):
    rng = np.random.default_rng(0)
    tree, residual = _tree(rng), {k: 1e-3 * _tie_free(rng, v.shape) for k, v in _tree(rng).items()}
    jp, jr = jcomp.topk_compress(tree, frac, residual)
    tp, tr = tcomp.topk_compress(tree, frac, residual)
    for k in tree:
        np.testing.assert_array_equal(tp[k]["idx"].numpy(), np.asarray(jp[k]["idx"]))
        assert tp[k]["idx"].dtype == torch.int32 and tp[k]["size"] == jp[k]["size"]
        np.testing.assert_array_equal(tp[k]["val"].numpy(), np.asarray(jp[k]["val"]))
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    jd = jcomp.topk_decompress(jp, tree)
    td = tcomp.topk_decompress(tp, tree)
    for k in tree:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    # a payload off the wire (numpy) decodes the same in both packages
    wire_payload = {k: {"idx": np.asarray(p["idx"]), "val": np.asarray(p["val"]),
                        "size": p["size"]} for k, p in jp.items()}
    jd = jcomp.decompress_payload(wire_payload, tree)
    td = tcomp.decompress_payload(wire_payload, tree)
    for k in tree:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_stochastic_scale_equals_jax_and_rounds_to_a_neighbour(bits):
    tree = _tree(np.random.default_rng(1))
    jq = jcomp.quantize_stochastic(tree, jax.random.key(0), bits=bits)
    tq = tcomp.quantize_stochastic(tree, torch.Generator().manual_seed(0), bits=bits)
    for k, x in tree.items():
        scale = tq[k]["scale"]
        assert scale.dtype == torch.float32
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jq[k]["scale"]))
        y = x / scale.numpy()
        q = tq[k]["q"].numpy().astype(np.float64)
        assert tq[k]["q"].dtype == (torch.int8 if bits == 8 else torch.int16)
        assert np.all((q == np.floor(y)) | (q == np.floor(y) + 1))
    # a quantized payload decodes alike in both packages
    payload = {k: {"idx": np.arange(v.size, dtype=np.int32), "size": v.size,
                   "val": {"q": np.asarray(jq[k]["q"]).ravel(),
                           "scale": np.asarray(jq[k]["scale"])}}
               for k, v in tree.items()}
    jd = jcomp.decompress_payload(payload, tree)
    td = tcomp.decompress_payload(payload, tree)
    for k in tree:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


@pytest.mark.parametrize("spec", ["q8", "q16", "topk:0.1", "topk:0.25:q8"])
def test_delta_blobs_are_byte_equal_across_the_packages(spec):
    """The manager's numpy delta path encoded by either package gives the
    same bytes, and so the same digest a worker checks its
    reconstruction against."""
    rng = np.random.default_rng(2)
    prev = {k: v.astype(np.float32) for k, v in _tree(rng).items()}
    new = {k: v + 0.01 * _tie_free(rng, v.shape) for k, v in prev.items()}
    jd = jcomp.delta_encode_state_dict(prev, new, jcomp.parse_delta_spec(spec), seed=5)
    td = tcomp.delta_encode_state_dict(prev, new, tcomp.parse_delta_spec(spec), seed=5)
    assert wire.encode(td, {}) == jwire.encode(jd, {})
    jr = jcomp.apply_delta_state_dict(prev, jd)
    tr = tcomp.apply_delta_state_dict(prev, td)
    assert wire.encode(tr, {}) == jwire.encode(jr, {})
    # the downlink's dense quantization, decoded by either package
    q = {k: np.asarray(v) for k, v in tcomp.quantize_state_dict(new, seed=3).items()}
    for k, v in tcomp.dequantize_state_dict(q).items():
        np.testing.assert_array_equal(v, jcomp.dequantize_state_dict(q)[k])


def test_error_feedback_runs_on_the_deltas_device_and_conserves_mass():
    """The residual stays where the deltas are, and transmitted plus
    residual equals the sum of the true deltas over rounds."""
    rng = np.random.default_rng(3)
    ef = tcomp.ErrorFeedbackCompressor(frac=0.1, bits=8, seed=4)
    deltas = [{k: torch.from_numpy(v) for k, v in _tree(rng).items()} for _ in range(3)]
    sent = {k: torch.zeros(v.shape) for k, v in deltas[0].items()}
    for d in deltas:
        ef.compress(d)
        exact = tcomp.topk_decompress(ef._last_exact, d)
        sent = {k: sent[k] + exact[k] for k in sent}
    for k in sent:
        assert ef.residual[k].device == deltas[0][k].device
        torch.testing.assert_close(sent[k] + ef.residual[k], sum(d[k] for d in deltas),
                                   rtol=1e-6, atol=1e-6)
