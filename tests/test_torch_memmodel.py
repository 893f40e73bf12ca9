"""The port's byte models (`repro_torch.core.memmodel`) against the JAX
package's `repro.core.memmodel`.

Both run the same arithmetic over the same `OpSpec`s, so every number of
`dycore_step_traffic`, `packed_exchange_model`, `kstep_exchange_model`,
`stencil_op_traffic` and `pipeline_step_traffic` agrees to `rel=1e-12`
(integers exactly) over a small set of grids, dtypes, windows, depths and
shard layouts, and both refuse the same too-deep halo.

`estimate`, the LM dry-run's per-device memory, is equal integer for
integer (every key, `fits_16g` too, against the `tpu_v5e` spec in both)
for all ten configurations x four shapes x both production meshes (train
at one and two microbatches). The JAX side runs once, in a subprocess
with 512 forced host devices (its `dryrun.py`'s setting), on
`make_production_mesh`; the port's side on `make_mesh` over 512 listed
CPU devices, which needs no process group.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import memmodel as jmemmodel
from repro.core import tiling as jtiling
from repro.weather.stencil_ops import get_stencil_op as jget_stencil_op
from repro_torch.core import memmodel, tiling
from repro_torch.weather.stencil_ops import get_stencil_op

REL = 1e-12
GRIDS = [(4, 16, 16), (3, 8, 12)]
DTYPES = ["float32", "bfloat16"]
SHARDS = [(1, 2), (2, 2), (2, 4)]


def _same_or_both_refuse(got_fn, want_fn):
    """`got_fn()` equals `want_fn()`, or both raise the too-deep-halo
    ValueError."""
    try:
        want = want_fn()
    except ValueError:
        with pytest.raises(ValueError, match="deep halo"):
            got_fn()
        return
    _assert_same(got_fn(), want)


def _assert_same(got, want, path="out"):
    """Equal keys all the way down; ints and strings exactly, floats to
    `REL`."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_fields,ty,k", [(4, 8, 1), (4, 5, 2), (1, 2, 3),
                                           (3, 16, 1)])
def test_dycore_step_traffic_matches(grid, dtype, n_fields, ty, k):
    got = memmodel.dycore_step_traffic(grid, dtype, n_fields=n_fields, ty=ty,
                                       k_steps=k)
    want = jmemmodel.dycore_step_traffic(grid, dtype, n_fields=n_fields,
                                         ty=ty, k_steps=k)
    _assert_same(got, want)
    assert ("fused_kstep" in got) == (k > 1)


@pytest.mark.parametrize("op", ["dycore", "hdiff", "vadvc", "hadv_upwind"])
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("exchange_dtype", [None, "bfloat16"])
def test_packed_exchange_model_matches_on_each_ops_rides(op, shards, k,
                                                         exchange_dtype):
    grid = (4, 16, 16)
    rides = get_stencil_op(op).memmodel_rides(4)
    assert rides == jget_stencil_op(op).memmodel_rides(4)
    halo = get_stencil_op(op).halo
    kw = dict(rides=rides, k=k, shards=shards,
              compute_halo=(k * halo, k * halo),
              exchange_dtype=exchange_dtype)
    _same_or_both_refuse(
        lambda: memmodel.packed_exchange_model(grid, "float32", **kw),
        lambda: jmemmodel.packed_exchange_model(grid, "float32", **kw))
    # the default compute halo (the widest ride) too
    kw = dict(rides=rides, k=k, shards=shards)
    _same_or_both_refuse(
        lambda: memmodel.packed_exchange_model(grid, "bfloat16", **kw),
        lambda: jmemmodel.packed_exchange_model(grid, "bfloat16", **kw))


def test_packed_exchange_model_refuses_a_halo_deeper_than_the_slab():
    rides = get_stencil_op("hdiff").memmodel_rides(2)
    for mod in (memmodel, jmemmodel):
        with pytest.raises(ValueError, match="deep halo"):
            mod.packed_exchange_model((4, 16, 16), "float32", rides=rides,
                                      k=3, shards=(4, 4))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("k,n_fields,exchange_dtype",
                         [(1, 4, None), (2, 4, None), (2, 3, "bfloat16")])
def test_kstep_exchange_model_matches(grid, shards, k, n_fields,
                                      exchange_dtype):
    kw = dict(n_fields=n_fields, k=k, shards=shards,
              exchange_dtype=exchange_dtype)
    _same_or_both_refuse(
        lambda: memmodel.kstep_exchange_model(grid, "float32", **kw),
        lambda: jmemmodel.kstep_exchange_model(grid, "float32", **kw))


@pytest.mark.parametrize("name", ["HDIFF", "VADVC", "HADV_UPWIND", "ASSELIN",
                                  "VADVC_UPDATE", "DYCORE_FUSED"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile,k,n_fields", [(None, 1, 1), ((1, 4, 16), 2, 4),
                                             ((4, 3, 8), 1, 3)])
def test_stencil_op_traffic_matches(name, dtype, tile, k, n_fields):
    got = memmodel.stencil_op_traffic(getattr(tiling, name), (4, 16, 16),
                                      dtype, n_fields=n_fields, tile=tile,
                                      k_steps=k)
    want = jmemmodel.stencil_op_traffic(getattr(jtiling, name), (4, 16, 16),
                                        dtype, n_fields=n_fields, tile=tile,
                                        k_steps=k)
    _assert_same(got, want)


@pytest.mark.parametrize("k", [1, 2])
def test_pipeline_step_traffic_matches(k):
    """The flagship chain hadv_upwind -> vadvc_update -> hdiff, its operand
    union written out as one spec in both packages."""
    def chain(mod):
        return mod.OpSpec(name="chain", fields_in=5, fields_out=2,
                          halo=(0, 2, 2), seq_axes=(0,), flops_per_point=66.0,
                          scratch_fields=3)
    stages = lambda mod: [(mod.HADV_UPWIND, 4), (mod.VADVC_UPDATE, 4),
                          (mod.HDIFF, 4), (mod.HDIFF, 2)]
    got = memmodel.pipeline_step_traffic(chain(tiling), stages(tiling),
                                         (4, 16, 16), "float32",
                                         tile=(4, 8, 16), k_steps=k)
    want = jmemmodel.pipeline_step_traffic(chain(jtiling), stages(jtiling),
                                           (4, 16, 16), "float32",
                                           tile=(4, 8, 16), k_steps=k)
    _assert_same(got, want)
    assert set(got["sequential_by_stage"]) == {"hadv_upwind", "vadvc_update",
                                               "hdiff", "hdiff#3"}


# ---------------------------------------------------------------------------
# estimate: the LM dry-run's memory model
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
MESH_KINDS = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}

_JAX_ESTIMATES = r"""
import json, sys
import jax
from repro.configs import registry
from repro.configs.base import SHAPES
from repro.core import hwspec, memmodel
from repro.launch.mesh import make_production_mesh
from repro.models import api
from repro.parallel import sharding as shd

spec = hwspec.load_spec("tpu_v5e")
out = {}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        model = api.build(cfg)
        p_shapes = model.param_shapes()
        for name, shape in SHAPES.items():
            kind = "train" if shape.kind == "train" else "serve"
            p_shard = shd.params_sharding(p_shapes, mesh, kind)
            cache = c_shard = None
            if shape.kind != "train":
                cache = jax.eval_shape(lambda: model.init_cache(
                    shape.global_batch, shape.seq_len))
                c_shard = shd.cache_sharding(cache, mesh, shape.global_batch)
            for mb in ((1, 2) if shape.kind == "train" else (1,)):
                out[f"{arch}|{name}|{mk}|{mb}"] = memmodel.estimate(
                    cfg, shape, mesh, p_shapes, p_shard, cache, c_shard,
                    microbatches=mb, spec=spec)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_estimates(tmp_path_factory):
    out = tmp_path_factory.mktemp("estimate") / "jax.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run([sys.executable, "-c", _JAX_ESTIMATES, str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def _port_estimates(arch, shape_name, mesh_kind):
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import hwspec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    dims, axes = MESH_KINDS[mesh_kind]
    mesh = make_mesh(dims, axes, devices=["cpu"] * 512)
    cfg = registry.get_config(arch)
    model = api.build(cfg, device="meta")
    p_shapes = model.param_shapes()
    shape = SHAPES[shape_name]
    kind = "train" if shape.kind == "train" else "serve"
    p_shard = shd.params_sharding(p_shapes, mesh, kind)
    cache = c_shard = None
    if shape.kind != "train":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        c_shard = shd.cache_sharding(cache, mesh, shape.global_batch, cfg)
    spec = hwspec.load_spec("tpu_v5e")
    return {mb: memmodel.estimate(cfg, shape, mesh, p_shapes, p_shard, cache,
                                  c_shard, microbatches=mb, spec=spec)
            for mb in ((1, 2) if shape.kind == "train" else (1,))}


_ARCHS = ["gemma3-27b", "granite-moe-3b-a800m", "mamba2-1.3b",
          "moonshot-v1-16b-a3b", "olmo-1b", "qwen2-vl-72b",
          "recurrentgemma-9b", "tinyllama-1.1b", "whisper-medium", "yi-34b"]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_estimate_matches_jax(jax_estimates, arch, shape_name, mesh_kind):
    for mb, got in _port_estimates(arch, shape_name, mesh_kind).items():
        want = jax_estimates[f"{arch}|{shape_name}|{mesh_kind}|{mb}"]
        assert got == want and all(
            type(got[k]) is type(want[k]) for k in want), (mb, got, want)


def test_estimate_fits_the_h100_by_default():
    """`fits_16g` keeps its name; on the port's default spec it means the
    total fits the H100's 80 GB: gemma3-27b's train_4k cell (23.1 GB a
    device) fits there and not in the v5e's 16 GiB."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import hwspec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    mesh = make_mesh((16, 16), ("data", "model"), devices=["cpu"] * 256)
    cfg = registry.get_config("gemma3-27b")
    p = api.build(cfg, device="meta").param_shapes()
    spec = shd.params_sharding(p, mesh, "train")
    est = memmodel.estimate(cfg, SHAPES["train_4k"], mesh, p, spec)
    v5e = memmodel.estimate(cfg, SHAPES["train_4k"], mesh, p, spec,
                            spec=hwspec.load_spec("tpu_v5e"))
    assert hwspec.default_spec().main.capacity_bytes == 80_000_000_000
    assert 16 * 2 ** 30 < est["total"] == v5e["total"] <= 80e9
    assert est["fits_16g"] and not v5e["fits_16g"]
