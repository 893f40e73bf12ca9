"""The port's halo exchange and sharding (`repro_torch.weather.domain`,
`repro_torch.launch.mesh`) against the JAX package's.

The JAX side needs four devices, so it runs once for the whole file in a
subprocess with four forced host devices, writing every case's result to
an `.npz` (the `reference` fixture). There the exchange functions run
under `shard_map` on a one-axis mesh of n = 1, 2 or 4 devices; here the
port's run over a mesh of n CPU shards. They agree bit for bit (the two
plain stencils after the exchange within their kernels' tolerances):

* `_exchange_packed`: ragged per-side depths, a side that ships nothing
  for one operand and for every operand (a ride elided), a direction
  nothing rides, a bfloat16 wire, along y and x;
* `_exchange`, `_staggered_w`, `_local_hdiff` and `_local_vadvc`;
* `failover_meshes`: the candidate (py, px) order over 1-4 devices.

The rides each call makes equal the JAX package's `ppermute`s. Port only:
`shard_state` / `gather_state` round-trip every mesh layout, `make_mesh`
refuses more shards than devices (a device is repeated only when the
caller lists it so), and `shard_state` refuses a state that does not
divide over the mesh.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import data_axes, make_mesh, make_production_mesh
from repro_torch.weather import domain, fields

ROOT = Path(__file__).resolve().parents[1]

# (name, dim, [(shape, depth), ...], wire dtype): operands sharded along
# `dim` (the global extent there is 16)
PACKED = [
    ("ragged_x", -1, [((2, 3, 4, 16), (2, 3)), ((2, 4, 16), (0, 1))], None),
    ("ragged_y", -2, [((2, 3, 16, 5), (1, 2)), ((2, 16, 5), 2)], None),
    ("one_side", -1, [((2, 3, 4, 16), (1, 0)), ((2, 4, 16), (0, 0))], None),
    ("nothing", -1, [((2, 3, 4, 16), (0, 0))], None),
    ("bf16_wire", -2, [((2, 3, 16, 5), (2, 2)), ((2, 16, 5), (2, 3))],
     "bfloat16"),
]
SHARDS = (1, 2, 4)
# the plain stencils after the exchange: the two packages' fp32 operation
# orders differ (the kernels' tests hold them to these tolerances)
PLAIN_TOL = {"local_hdiff": 1e-5, "local_vadvc": 2e-4}
GRIDS = [[(4, 16, 16)], [(4, 12, 16), (4, 16, 8)], [(4, 6, 9)]]
LIKES = [None, (2, 1), (1, 2), (2, 2)]


def _inputs(name, parts):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return [rng.standard_normal(shape).astype(np.float32)
            for shape, _ in parts]


_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.launch.mesh import make_mesh
from repro.weather import domain
from repro.core import trace_stats

cases = json.loads(sys.argv[1])
out = {}
for c in cases:
    n, dim = c["n"], c["dim"]
    mesh = make_mesh((n,), ("x",))
    xs = [np.load(c["path"])[f"a{i}"] for i in range(len(c["depths"]))]
    depths = [d if isinstance(d, int) else tuple(d) for d in c["depths"]]
    spec = lambda a: P(*([None] * (a.ndim + dim) + ["x"]
                         + [None] * (-dim - 1)))
    specs = tuple(spec(a) for a in xs)
    wire = c["wire"]
    if c["fn"] == "packed":
        def f(*arrs):
            return tuple(domain._exchange_packed(
                list(zip(arrs, depths)), "x", n, dim=dim,
                wire_dtype=None if wire is None else jnp.dtype(wire)))
    elif c["fn"] == "exchange":
        def f(a):
            return (domain._exchange(a, "x", n, depths[0], dim=dim),)
    elif c["fn"] == "staggered_w":
        def f(a):
            return (domain._staggered_w(a, "x", n),)
    elif c["fn"] == "local_hdiff":
        def f(a):
            return (domain._local_hdiff(a, 0.05, "x", "x", 1, n),)
    else:   # local_vadvc: (u, wcon, tens, stage), all x-sharded
        def f(u, w, t, s):
            return (domain._local_vadvc(u, w, u, t, s, "x", n),)
    fn = shard_map(f, mesh, in_specs=specs,
                   out_specs=specs if c["fn"] == "packed" else specs[:1])
    got = jax.jit(fn)(*[jnp.asarray(a) for a in xs])
    rides = trace_stats.count_primitive(jax.make_jaxpr(fn)(*xs), "ppermute")
    out[c["key"]] = {"rides": rides}
    np.savez(c["out"], *[np.asarray(g) for g in got])

devs = jax.devices()
fail = {}
for k in range(1, 5):
    for gi, grids in enumerate(json.loads(sys.argv[2])):
        for like in json.loads(sys.argv[3]):
            ms = domain.failover_meshes(devs[:k], [tuple(g) for g in grids],
                                        like=None if like is None
                                        else tuple(like))
            fail[f"{k}/{gi}/{like}"] = [list(m.devices.shape) for m in ms]
out["failover"] = fail
print("RESULT " + json.dumps(out))
"""


def _cases(tmp):
    """Every exchange case: its inputs on disk and its JSON description."""
    cases = []

    def add(key, fn, dim, arrays, depths, wire=None):
        path = tmp / f"{key}-in.npz"
        np.savez(path, **{f"a{i}": a for i, a in enumerate(arrays)})
        for n in SHARDS:
            cases.append({"key": f"{key}/{n}", "fn": fn, "n": n, "dim": dim,
                          "path": str(path), "depths": depths, "wire": wire,
                          "out": str(tmp / f"{key}-{n}-out.npz")})

    for name, dim, parts, wire in PACKED:
        add(name, "packed", dim, _inputs(name, parts),
            [d for _, d in parts], wire)
    rng = np.random.default_rng(7)
    state = lambda: rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    add("exchange", "exchange", -1, [state()], [2])
    add("staggered_w", "staggered_w", -1, [state()], [0])
    add("local_hdiff", "local_hdiff", -1, [state()], [0])
    add("local_vadvc", "local_vadvc", -1,
        [state(), 0.15 * state(), 0.01 * state(), 0.01 * state()],
        [0, 0, 0, 0])
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("domain")
    cases = _cases(tmp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           # one thread: the suite's other workers share the cores
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(cases),
                        json.dumps(GRIDS), json.dumps(LIKES)], env=env,
                       capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return {c["key"]: c for c in cases}, json.loads(line[0][7:])


def _mesh(n):
    return make_mesh((n,), ("x",), devices=["cpu"] * n)


def _split(a, n, dim):
    return [t.contiguous() for t in torch.from_numpy(a).chunk(n, dim=dim)]


def _port(case):
    """The port's result of one case: (outputs, rides)."""
    n, dim = case["n"], case["dim"]
    mesh = _mesh(n)
    ins = np.load(case["path"])
    xs = [_split(ins[f"a{i}"], n, dim) for i in range(len(case["depths"]))]
    depths = [d if isinstance(d, int) else tuple(d) for d in case["depths"]]
    domain.reset_rides()
    fn = case["fn"]
    if fn == "packed":
        outs = domain._exchange_packed(list(zip(xs, depths)), mesh, "x",
                                       dim=dim, wire_dtype=case["wire"])
    elif fn == "exchange":
        outs = [domain._exchange(xs[0], mesh, "x", depths[0], dim=dim)]
    elif fn == "staggered_w":
        outs = [domain._staggered_w(xs[0], mesh, "x")]
    elif fn == "local_hdiff":
        # the y axis is not split: a one-shard axis the mesh lacks
        outs = [domain._local_hdiff(xs[0], 0.05, mesh, None, "x")]
    else:
        u, w, t, s = xs
        outs = [domain._local_vadvc(u, w, u, t, s, mesh, "x")]
    return ([torch.cat(o, dim=dim).numpy() for o in outs],
            domain.RIDES["rides"])


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", [c[0] for c in PACKED]
                         + ["exchange", "staggered_w", "local_hdiff",
                            "local_vadvc"])
def test_exchange_matches_the_reference(reference, name, n):
    cases, res = reference
    case = cases[f"{name}/{n}"]
    got, rides = _port(case)
    want = np.load(case["out"])
    assert len(got) == len(want.files)
    for i, g in enumerate(got):
        w = want[f"arr_{i}"]
        assert g.shape == w.shape
        if name in PLAIN_TOL:           # plain stencils, each in fp32
            np.testing.assert_allclose(g, w, atol=PLAIN_TOL[name], rtol=0)
        else:
            np.testing.assert_array_equal(g, w)
    assert rides == res[f"{name}/{n}"]["rides"]


def test_rides_count_what_the_wire_carries():
    """A packed ride moves one buffer a shard: the operands' sides at the
    wire dtype; a zero side adds nothing, and one shard rides nothing."""
    name, dim, parts, _ = PACKED[0]
    arrays = _inputs(name, parts)
    for n, wire in ((4, None), (4, "bfloat16"), (1, None)):
        xs = [_split(a, n, dim) for a in arrays]
        domain.reset_rides()
        domain._exchange_packed([(x, d) for x, (_, d) in zip(xs, parts)],
                                _mesh(n), "x", dim=dim, wire_dtype=wire)
        per_side = lambda side: sum(
            np.prod(a.shape[:-1]) * d[side] if not isinstance(d, int)
            else np.prod(a.shape[:-1]) * d for a, (_, d) in zip(arrays,
                                                                  parts))
        nbytes = 2 if wire else 4
        want = 0 if n == 1 else n * nbytes * (per_side(0) + per_side(1))
        assert domain.RIDES == {"rides": 0 if n == 1 else 2, "bytes": want}


def test_failover_candidates_match_the_reference(reference):
    _, res = reference
    for key, shapes in res["failover"].items():
        k, gi, like = key.split("/")
        like = None if like == "None" else tuple(json.loads(like))
        got = domain.failover_meshes(["cpu"] * int(k), GRIDS[int(gi)],
                                     like=like)
        assert [list(m.devices.shape) for m in got] == shapes, key
        assert all(m.axis_names == ("data", "model") for m in got)


def _state(seed=0, ensemble=4):
    g = torch.Generator().manual_seed(seed)
    return fields.initial_state(g, (3, 8, 12), ensemble=ensemble,
                                device="cpu")


@pytest.mark.parametrize("shape,axes,spec", [
    ((2, 2), ("data", "model"), (None, None, "data", "model")),
    ((4, 1), ("data", "model"), (None, None, "data", "model")),
    ((1, 4), ("data", "model"), (None, None, "data", "model")),
    ((2, 1, 2), ("pod", "data", "model"), ("pod", None, "data", "model")),
    ((2, 2), ("data", "model"), (None, None, "data", None)),
])
def test_shard_and_gather_round_trip(shape, axes, spec):
    st = _state()
    mesh = make_mesh(shape, axes, devices=["cpu"] * 4)
    sh = domain.shard_state(st, mesh, spec)
    assert len(sh.shards) == 4 and sh.grid_shape == (3, 8, 12)
    assert domain.shard_state(sh, mesh, spec) is sh
    for s in sh.shards:              # field-stacked, contiguous
        base = s.fields["u"]
        assert base.untyped_storage().data_ptr() == \
            s.fields["pp"].untyped_storage().data_ptr()
    back = domain.gather_state(sh)
    for a, b in zip(fields.state_leaves(back), fields.state_leaves(st)):
        assert torch.equal(a, b)
    # resharding onto another layout goes through the whole state
    other = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    moved = domain.shard_state(sh, other, (None, None, "data", "model"))
    for a, b in zip(fields.state_leaves(domain.gather_state(moved)),
                    fields.state_leaves(st)):
        assert torch.equal(a, b)


def test_shard_state_refuses_what_does_not_divide():
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    st = fields.initial_state(torch.Generator().manual_seed(0), (3, 8, 10),
                              device="cpu")
    with pytest.raises(ValueError, match="divide"):
        domain.shard_state(st, mesh, (None, None, "data", "model"))
    with pytest.raises(ValueError, match="lacks"):
        domain.shard_state(st, mesh, ("pod", None, "data", "model"))


def test_make_mesh_never_repeats_a_device_on_its_own():
    with pytest.raises(RuntimeError, match="need 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert data_axes(mesh) == ("data",)
    assert data_axes(make_mesh((1, 1, 1), ("pod", "data", "model"),
                               devices=["cpu"])) == ("pod", "data")
    with pytest.raises(RuntimeError):     # 256 devices: more than any here
        make_production_mesh()
    assert mesh.neighbor(0, "model", 1) == 1
    assert mesh.neighbor(0, "data", -1) == 2
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_mesh((n,), ("x",)).device_type == "cuda"
        with pytest.raises(RuntimeError, match="devices"):
            make_mesh((n + 1,), ("x",))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1,), ("x",))
