"""The port's roofline terms (`repro_torch.core.roofline`) against the JAX
package's `repro.core.roofline`.

Both run the same arithmetic, so for the same per-device cost,
collectives, chip count and model FLOPs every term, the dominant one, the
bound and the fractions are equal, float for float, under the `tpu_v5e`
and the `h100_sxm` spec (the JAX package reads the H100's JSON from the
port's spec directory). The one difference by design: with no spec the
port takes `hwspec.default_spec()`, the H100, where the JAX package takes
its TPU v5e constants.
"""

import pytest

pytest.importorskip("torch")

from repro.core import hwspec as jhwspec
from repro.core import roofline as jrl
from repro_torch.core import hwspec, op_cost, roofline

SPECS = ["tpu_v5e", "h100_sxm"]
CASES = [
    # (cost, collectives, chips, model flops, dtype bytes)
    ({"flops": 7.87e13, "bytes accessed": 2.92e12}, {"all-reduce": 2.95e10,
     "all-gather": 6.13e8, "reduce-scatter": 2.68e7}, 256, 6.92e15, 2),
    ({"flops": 3.1e11, "bytes accessed": 9.0e11, "bytes fused": 4.0e11},
     {}, 512, 1.2e14, 2),
    ({"flops": 5.0e9, "bytes accessed": 1.0e8}, {"all-to-all": 3e9,
     "collective-permute": 1e6}, 8, 2.0e12, 4),
    ({"flops": 0.0, "bytes accessed": 0.0}, {}, 1, 0.0, 2),
]


def _jax_spec(name):
    return jhwspec.load_spec(name, directory=hwspec.spec_dir())


def _fields(t):
    return (t.flops_per_device, t.bytes_per_device,
            t.collective_bytes_per_device, t.compute_s, t.memory_s,
            t.collective_s, t.dominant, t.model_flops_total,
            t.useful_flops_ratio, t.chips, t.peak_flops, t.step_time_s,
            t.roofline_fraction)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_analyze_matches_jax(spec, case):
    cost, coll, chips, mf, db = CASES[case]
    got = roofline.analyze(cost, coll, chips, mf, dtype_bytes=db,
                           spec=hwspec.load_spec(spec))
    want = jrl.analyze(cost, coll, chips, mf, dtype_bytes=db,
                       spec=_jax_spec(spec))
    assert _fields(got) == _fields(want)


def test_default_spec_is_the_h100():
    """A difference by design: no spec is the H100 in the port, the v5e
    in the JAX package."""
    cost, coll, chips, mf, db = CASES[0]
    got = roofline.analyze(cost, coll, chips, mf)
    assert hwspec.default_spec_name() == "h100_sxm"
    assert _fields(got) == _fields(jrl.analyze(
        cost, coll, chips, mf, spec=_jax_spec("h100_sxm")))
    assert _fields(got) != _fields(jrl.analyze(cost, coll, chips, mf))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,active,tokens", [(1_100_048_384, 1_100_048_384,
                                              1_048_576),
                                             (3_300_000_000, 800_000_000,
                                              128)])
def test_model_flops_matches_jax(kind, n, active, tokens):
    assert (roofline.model_flops(n, active, tokens, kind)
            == jrl.model_flops(n, active, tokens, kind))


@pytest.mark.parametrize("coll", [c[1] for c in CASES])
def test_wire_bytes_matches_jax(coll):
    assert roofline._WIRE_FACTOR == jrl._WIRE_FACTOR
    assert roofline.wire_bytes(coll) == jrl.wire_bytes(coll)


def test_collective_bytes_reads_the_counters_record():
    """The twin of the JAX package's HLO parse takes an `op_cost.Cost`."""
    cost = op_cost.Cost(collective_bytes={"all-gather": 2097152.0,
                                          "all-reduce": 10.0})
    assert roofline.collective_bytes(cost) == {"all-gather": 2097152,
                                               "all-reduce": 10}
    assert jrl.collective_bytes(
        "%ag = bf16[256,4096]{1,0} all-gather(bf16[16,4096]{1,0} %p)") \
        == {"all-gather": 2097152}
