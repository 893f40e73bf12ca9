"""The LM dry-run: trace every (arch x shape x mesh) cell on a fake world.

A port of `repro.launch.dryrun`. The JAX package lowers and compiles each
cell's SPMD step against shape-only inputs on 512 forced host devices and
reads XLA's memory and cost analyses. The port has no compiler to ask, so
it runs each cell's real step (`make_train_step(mesh=)`, `Model.prefill`
or `Model.decode_step`, under the production shardings of
`parallel/sharding.py`) as rank 0 of a fake world of 256 or 512 ranks
(the "fake" process-group backend: collectives move nothing) on fake
tensors (`core/op_cost.py::OpCounter`: shapes and dtypes, no storage).
Nothing is allocated, built or launched; each hand-written kernel's
wrapper records its call and its own cost instead. Per cell it records:

  * `memory.analytic`: `core/memmodel.py::estimate`, the JAX package's
    model, and `memory.fits_16g` (the total fits the spec's main memory:
    80 GB on the default H100 spec); `memory.fake_live_bytes_per_device`,
    the peak of live fake storage during the step (the twin of the JAX
    dry-run's XLA:CPU live bytes);
  * `cost`: rank 0's FLOPs, transcendentals and bytes accessed, and each
    kernel's calls and cost (`core/op_cost.py`);
  * `collectives`: result bytes per device by kind;
  * `roofline`: the terms of `core/roofline.py` against the spec.

The fake tensors sit on the CPU and the mesh is a "cpu" `DeviceMesh`:
indexing a fake CUDA tensor needs a CUDA build of PyTorch, and the
kernels' trace route keys on the tensor being fake, not on its device.

`--seq-shard` traces each cell under `activation_rules(...,
seq_shard=True)` (sequence parallelism in train and prefill; a decode
step is unchanged) and records `"seq_shard": true`; its results are
cached apart (`__seq` in the file name).

Differences from the JAX dry-run by design. `--attn-kernel` and
`--fsdp-gather` are not offered: the port always runs the flash kernel
and always gathers a block's weights at use (`parallel/policy.py`), and
every result records `"attn_kernel": true, "fsdp_gather": true`. Times
are `trace_s` (the eager trace) in place of `lower_s` / `compile_s`. The
roofline is the H100's unless `REPRO_HWSPEC` names another spec. Results
go to `build/dryrun/`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

With `--all` the per-cell markdown tables (`markdown_table`) follow the
cells' lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core import hwspec, memmodel, op_cost
from repro_torch.core import roofline as rl
from repro_torch.launch.mesh import make_device_mesh, production_shape
from repro_torch.models import api
from repro_torch.models.common import torch_dtype
from repro_torch.parallel import policy
from repro_torch.parallel import sharding as shd
from repro_torch.train import loop as train_loop
from repro_torch.train import optim as opt_lib

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))

# the prompt whose prefill leaves a decode cell's cache (long enough for
# every conv state and SSD chunk)
PROMPT = 64

# the production meshes' (shape, axes)
MESHES = {"single": production_shape(),
          "multi": production_shape(multi_pod=True)}


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake world of `world` ranks, once; a
    fake world already this large is kept. Raises where the process holds
    a real process group: a cell never traces beside one."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry-run traces as rank 0 of a fake world; this process "
                f"holds a {dist.get_backend()} process group")
        if dist.get_world_size() < world:
            raise RuntimeError(f"the fake world has {dist.get_world_size()} "
                               f"ranks; a mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def cell_mesh(shape, axes):
    """A "cpu" `DeviceMesh` of `shape` on the fake world (made if need
    be)."""
    fake_world(math.prod(shape))
    return make_device_mesh(shape, axes, device_type="cpu")


def cell_config(arch: Union[str, ModelConfig], *, moe_impl: str = "",
                moe_chunk: int = 0, kv_dtype: str = "") -> ModelConfig:
    cfg = registry.get_config(arch) if isinstance(arch, str) else arch
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    if cfg.moe and (moe_impl or moe_chunk):
        kw = {}
        if moe_impl:
            kw["impl"] = moe_impl
        if moe_chunk:
            kw["router_chunk"] = moe_chunk
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **kw))
    return cfg


def input_specs(model: api.Model, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of this cell (the JAX
    package's ShapeDtypeStructs); decode's `pos` is the cache's last
    position."""
    cfg = model.cfg
    if shape.kind in ("train", "prefill"):
        return model.batch_spec(shape.global_batch, shape.seq_len)
    spec = {"token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": shape.seq_len - 1}
    if cfg.encdec:
        spec["frames"] = torch.empty(
            (shape.global_batch, cfg.encdec.encoder_len, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device="meta")
    return spec


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor of `t`'s shape and dtype (inside an OpCounter)."""
    return torch.empty(t.shape, dtype=t.dtype)


def _fake_params(model: api.Model, mesh, kind: str, specs=None):
    """The model's parameters as fake DTensors placed by the rule table."""
    params = model.param_shapes()
    for name, p in list(params.named_parameters()):
        shd._set_param(params, name, _fake(p))
    return shd.distribute(params, mesh, kind, specs)


def build_cell(arch, shape_name, mesh, *, remat: str = "full",
               microbatches: int = 1, moe_impl: str = "",
               moe_chunk: int = 0, grad_dtype: str = "float32",
               kv_dtype: str = "", seq_shard: bool = False):
    """Inside an `OpCounter`: the cell's fake inputs, placed on `mesh`, and
    (fn, meta), fn() running the step once under the activation rules
    (`seq_shard` theirs). `arch` is a name or a config, `shape_name` a
    name of `SHAPES` or a `ShapeConfig`."""
    cfg = cell_config(arch, moe_impl=moe_impl, moe_chunk=moe_chunk,
                      kv_dtype=kv_dtype)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    model = api.build(cfg, device="cpu")
    chips = mesh.size()
    specs = input_specs(model, shape)
    b_axes = shd.batch_sharding(mesh, shape.global_batch)
    meta = dict(cfg=cfg, shape=shape, chips=chips, kind=shape.kind)
    rules = lambda: policy.activation_rules(                # noqa: E731
        b_axes, mesh, seq_shard=seq_shard)

    if shape.kind == "train":
        step, (p_spec, _) = train_loop.make_train_step(
            model, opt_lib.OptConfig(), microbatches=microbatches,
            remat=remat, grad_dtype=grad_dtype, mesh=mesh)
        params = _fake_params(model, mesh, "train", p_spec)
        opt_state = opt_lib.init_opt_state(params)
        batch = train_loop.shard_batch({k: _fake(v) for k, v in
                                        specs.items()}, mesh)
        meta["tokens"] = shape.global_batch * shape.seq_len

        def train_fn():
            with rules():
                return step(params, opt_state, batch)

        return train_fn, meta

    params = _fake_params(model, mesh, "serve")
    if shape.kind == "prefill":
        batch = train_loop.shard_batch({k: _fake(v) for k, v in
                                        specs.items()}, mesh)

        def prefill_fn():
            with rules(), torch.no_grad():
                logits, cache = model.prefill(params, batch,
                                              max_len=shape.seq_len)
            return logits[:, -1:], cache

        meta["tokens"] = shape.global_batch * shape.seq_len
        return prefill_fn, meta

    # decode: one new token against the rank's seq_len-deep cache, the one
    # a short prompt's prefill leaves (traced here, not counted)
    pos = specs.pop("pos")
    inputs = train_loop.shard_batch({k: _fake(v) for k, v in specs.items()},
                                    mesh)
    prompt = {"tokens": train_loop.shard_batch({"t": torch.empty(
        (shape.global_batch, min(PROMPT, shape.seq_len)),
        dtype=torch.int32)}, mesh)["t"]}
    if "frames" in inputs:
        prompt["frames"] = inputs["frames"]
    with rules(), torch.no_grad():
        _, cache = model.prefill(params, prompt, max_len=shape.seq_len)

    def decode_fn():
        with rules(), torch.no_grad():
            return model.decode_step(params, cache, inputs["token"], pos)

    meta["tokens"] = shape.global_batch
    return decode_fn, meta


def choose_microbatches(cfg, shape, mesh, spec=None) -> int:
    """Smallest gradient-accumulation depth whose analytic per-device
    estimate fits the spec's main memory (the production launcher's knob;
    recorded in the result). Non-train shapes always use 1."""
    if shape.kind != "train":
        return 1
    p_shapes = api.build(cfg, device="meta").param_shapes()
    p_shard = shd.params_sharding(p_shapes, mesh, "train")
    b_axes = shd.batch_sharding(mesh, shape.global_batch)
    dp = 1
    if b_axes:
        axes = b_axes if isinstance(b_axes, tuple) else (b_axes,)
        dp = math.prod(shd.mesh_shape(mesh)[a] for a in axes)
    cap = max(shape.global_batch // dp, 1)
    mb = 1
    while mb < cap:
        est = memmodel.estimate(cfg, shape, mesh, p_shapes, p_shard,
                                microbatches=mb, spec=spec)
        if est["fits_16g"]:
            break
        mb *= 2
    return min(mb, cap)


def analytic_memory(cfg, shape, mesh, microbatches: int, spec=None) -> dict:
    """`memmodel.estimate` of the cell, its inputs from meta tensors."""
    meta_model = api.build(cfg, device="meta")
    p_shapes = meta_model.param_shapes()
    kind = "train" if shape.kind == "train" else "serve"
    p_shard = shd.params_sharding(p_shapes, mesh, kind)
    cache = c_shard = None
    if shape.kind != "train":
        cache = meta_model.init_cache(shape.global_batch, shape.seq_len)
        c_shard = shd.cache_sharding(cache, mesh, shape.global_batch, cfg)
    return memmodel.estimate(cfg, shape, mesh, p_shapes, p_shard, cache,
                             c_shard, microbatches=microbatches, spec=spec)


def trace_cell(arch, shape_name, mesh, *, remat: str = "full",
               microbatches: int = 1, moe_impl: str = "",
               moe_chunk: int = 0, grad_dtype: str = "float32",
               kv_dtype: str = "", seq_shard: bool = False,
               spec=None) -> dict:
    """Trace one cell's step on `mesh` (a `DeviceMesh` of a fake world,
    `cell_mesh`) as rank 0 and return its result's measured keys:
    `chips`, `trace_s`, `memory`, `cost`, `collectives`, `kernel_calls`,
    `tokens`, `model_flops`, `param_count`, `active_param_count`,
    `roofline`. `spec` is a `HardwareSpec` (default the process's)."""
    spec = spec or hwspec.default_spec()
    counter = op_cost.OpCounter()
    t0 = time.time()
    with counter:
        fn, meta = build_cell(arch, shape_name, mesh, remat=remat,
                              microbatches=microbatches, moe_impl=moe_impl,
                              moe_chunk=moe_chunk, grad_dtype=grad_dtype,
                              kv_dtype=kv_dtype, seq_shard=seq_shard)
        with counter.counting():
            out = fn()
        del out
    trace_s = time.time() - t0
    cfg, shape, cost = meta["cfg"], meta["shape"], counter.cost
    analytic = analytic_memory(cfg, shape, mesh, microbatches, spec)
    mem = {"analytic": {k: int(v) if not isinstance(v, bool) else v
                        for k, v in analytic.items()},
           "fits_16g": analytic["fits_16g"],
           "fake_live_bytes_per_device": int(counter.peak_live_bytes)}
    cost_small = {"flops": cost.flops,
                  "bytes accessed": cost.bytes_accessed,
                  "transcendentals": cost.transcendentals,
                  "ops": cost.ops,
                  "kernels": cost.kernels}
    coll = rl.collective_bytes(cost)
    mf = rl.model_flops(cfg.param_count(), cfg.active_param_count(),
                        meta["tokens"], meta["kind"])
    terms = rl.analyze(cost_small, coll, meta["chips"], mf,
                       dtype_bytes=torch_dtype(cfg.dtype).itemsize,
                       spec=spec)
    return dict(
        chips=meta["chips"], trace_s=round(trace_s, 2), spec=spec.name,
        memory=mem, cost=cost_small, collectives=coll,
        kernel_calls=cost.kernel_calls(), tokens=meta["tokens"],
        model_flops=mf, param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        attn_kernel=True, fsdp_gather=True, seq_shard=seq_shard,
        roofline=dict(
            compute_s=terms.compute_s, memory_s=terms.memory_s,
            collective_s=terms.collective_s, dominant=terms.dominant,
            step_time_bound_s=terms.step_time_s,
            useful_flops_ratio=terms.useful_flops_ratio,
            roofline_fraction=terms.roofline_fraction))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             remat: str = "full", microbatches: int = 0,
             variant: str = "baseline", force: bool = False,
             moe_impl: str = "", moe_chunk: int = 0,
             grad_dtype: str = "float32", kv_dtype: str = "",
             seq_shard: bool = False) -> dict:
    """One cell on the production mesh `mesh_kind` ("single": (16, 16),
    "multi": (2, 16, 16)), cached as JSON under `RESULTS_DIR` (recomputed
    with `force`; a `seq_shard` cell apart). `status` is "ok", "skipped"
    (by `registry.skips`) or "error" (the exception and its traceback
    recorded)."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = os.path.join(
        RESULTS_DIR, f"{arch}__{shape_name}__{mesh_kind}__{variant}"
                     + ("__seq" if seq_shard else "") + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = registry.get_config(arch)
    why_skip = registry.skips(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant, "remat": remat,
              "microbatches": microbatches, "seq_shard": seq_shard}
    if why_skip:
        result.update(status="skipped", reason=why_skip)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    try:
        mesh = cell_mesh(*MESHES[mesh_kind])
        shape = SHAPES[shape_name]
        if not microbatches:
            microbatches = choose_microbatches(cfg, shape, mesh)
            result["microbatches"] = microbatches
        result.update(trace_cell(
            arch, shape_name, mesh, remat=remat, microbatches=microbatches,
            moe_impl=moe_impl, moe_chunk=moe_chunk, grad_dtype=grad_dtype,
            kv_dtype=kv_dtype, seq_shard=seq_shard))
        result["status"] = "ok"
    except Exception as e:      # noqa: BLE001 — record the failure
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def summary(r: dict) -> dict:
    """A result's one-line form, as the CLI prints it."""
    line = {k: r.get(k) for k in ("arch", "shape", "mesh", "status")}
    if r.get("status") == "ok":
        line["dominant"] = r["roofline"]["dominant"]
        line["fit"] = r["memory"].get("fits_16g")
        line["trace_s"] = r.get("trace_s")
        line["bound_s"] = r["roofline"]["step_time_bound_s"]
        line["GB/dev"] = round(
            r["memory"].get("analytic", {}).get("total", 0) / 1e9, 2)
        line["GB/dev_fake"] = round(
            r["memory"].get("fake_live_bytes_per_device", 0) / 1e9, 2)
    elif r.get("status") == "error":
        line["error"] = r.get("error", "")[:140]
    else:
        line["reason"] = r.get("reason")
    return line


def markdown_table(results) -> str:
    """The per-cell tables, one a mesh: a row an arch, a column a shape;
    an ok cell reads "<dominant term> <bound s> · <analytic GB> /
    <fake live GB> a device · <trace s>", marked "(no fit)" where the
    analytic total does not fit the spec's memory."""
    shapes = list(SHAPES)
    out = []
    for mesh_kind in dict.fromkeys(r["mesh"] for r in results):
        out += [f"| {mesh_kind} | " + " | ".join(shapes) + " |",
                "| --- |" + " --- |" * len(shapes)]
        rows = {}
        for r in results:
            if r["mesh"] != mesh_kind:
                continue
            if r.get("status") == "ok":
                m, rf = r["memory"], r["roofline"]
                cell = (f"{rf['dominant'][:4]} {rf['step_time_bound_s']:.4g}"
                        f" · {m['analytic']['total'] / 1e9:.1f} / "
                        f"{m['fake_live_bytes_per_device'] / 1e9:.1f} · "
                        f"{r['trace_s']:.0f} s"
                        + ("" if m["fits_16g"] else " (no fit)"))
            else:
                cell = r.get("status")
            rows.setdefault(r["arch"], {})[r["shape"]] = cell
        out += [f"| {a} | " + " | ".join(c.get(sh, "") for sh in shapes)
                + " |" for a, c in rows.items()]
        out.append("")
    return "\n".join(out).rstrip()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=("full", "dots", "none"))
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (smallest depth that fits the spec)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--moe-impl", default="",
                    choices=("", "onehot", "gather"),
                    help="override MoE dispatch implementation")
    ap.add_argument("--moe-chunk", type=int, default=0,
                    help="override MoE router chunk (tokens)")
    ap.add_argument("--grad-bf16", action="store_true",
                    help="bf16 microbatch grad accumulation")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with per-(pos,head) scales")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel (B, T, D) activations over the "
                         "model axis (train and prefill)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = ([(a, s) for a in registry.ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    fake_world(max(math.prod(MESHES[m][0]) for m in meshes))
    results = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            r = run_cell(arch, shape, mesh_kind, remat=args.remat,
                         microbatches=args.microbatches,
                         variant=args.variant, force=args.force,
                         moe_impl=args.moe_impl, moe_chunk=args.moe_chunk,
                         grad_dtype="bfloat16" if args.grad_bf16
                         else "float32",
                         kv_dtype="int8" if args.kv_int8 else "",
                         seq_shard=args.seq_shard)
            results.append(r)
            print(json.dumps(summary(r)), flush=True)
    if args.all:
        print(markdown_table(results))
    return 1 if any(r.get("status") == "error" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
