"""Modelled main-memory and wire bytes of the stencil ops, and the LM
dry-run's per-device memory estimate.

A port of `repro.core.memmodel`, in the JAX package's arithmetic and
under its key names, built on the port's `tiling.TilePlan` and `OpSpec`s.
`ExecutionPlan.report()["traffic"]` and the k-step resolver
(`autotune.plan_k_steps`) read the stencil half; `launch/dryrun.py` reads
`estimate`, the analytic per-device bytes of a train, prefill or decode
step (written by the JAX package for a TPU: param, optimizer and grad
shards, remat carries, a working set), which the dry-run records beside
the fake trace's live peak.

What it counts is the JAX package's model of a TPU window: each `TilePlan`
window staged whole into near memory, its halo re-read from main memory.
The fused dycore has two bounds: `stream_window_reads`, the Pallas kernel
as written (three whole-window fetches an input), and `stream`, the
line-buffer ideal (each input read once plus the window's halo). These are
model bytes, kept for parity with the JAX package and to compare with the
bytes a CUDA kernel achieves on the card (bytes over the measured time);
they are not the CUDA kernels' own access patterns, and carry no time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.core import hierarchy as hw
from repro_torch.core import tiling
from repro_torch.weather.fields import dtype_name


def dycore_step_traffic(grid_shape, dtype, *, n_fields: int = 4,
                        ty: int = 8,
                        k_steps: int = 1) -> Dict[str, Dict[str, int]]:
    """Modelled main-memory bytes of one dycore step, fused against
    unfused (NERO's fusion accounting, arxiv 2107.08716 §3: the baseline's
    intermediates round-trip main memory between kernels; the fused
    pipeline streams each field once), per ensemble member, for `n_fields`
    fields on a (nz, ny, nx) grid.

    Unfused (the `variant="unfused"` plan): vadvc reads f, wcon, utens,
    utens_stage and writes stage; the point-wise update reads f, stage and
    writes f'; hdiff wrap-pads (reads f', writes the padded copy), reads
    it and writes f''.

    Fused, two bounds over a (nz, ty, nx) window: `stream`, the line-buffer
    ideal (each input once plus the window's 2-row y-halo, 2 writes, and
    one shared w = wcon_i + wcon_{i+1} precompute); `stream_window_reads`,
    three whole-window fetches an input, as the Pallas kernel's aliased
    prev/cur/next windows fetch them. `fused_whole` is the whole-state
    variant (w amortized over the fields). With `k_steps > 1`,
    `fused_kstep` counts a k-step round: the carried state (field and stage
    read and written) once a round instead of once a step, at the price of
    a three-window working slab.

    Returns {"unfused", "fused", "fused_whole", ["fused_kstep"],
    "reduction_x", "reduction_x_window_reads", "reduction_x_whole",
    "reduction_x_whole_window_reads", "halo_overhead", ...}."""
    grid_shape = tuple(int(g) for g in grid_shape)
    b = hw.dtype_bytes(dtype)
    pts = math.prod(grid_shape)
    fb = pts * b                                   # one field's bytes
    dn = dtype_name(dtype)

    unfused = {
        "vadvc": n_fields * (4 + 1) * fb,
        "pointwise": n_fields * (2 + 1) * fb,
        "hdiff_pad": n_fields * 2 * fb,            # materialized wrap-pad
        "hdiff": n_fields * 2 * fb,
    }
    unfused["total"] = sum(unfused.values())

    nz, ny, nx = grid_shape
    ty = max(2, min(ty, ny))
    plan = tiling.TilePlan(op=tiling.DYCORE_FUSED, grid_shape=grid_shape,
                           tile=(nz, ty, nx), dtype=dn)
    n_in = tiling.DYCORE_FUSED.fields_in
    n_out = tiling.DYCORE_FUSED.fields_out
    fused = {
        "stream": n_fields * plan.hbm_bytes_total,  # 4 in (+halo) + 2 out
        "w_precompute": 2 * fb,                     # shared across fields
    }
    fused["total"] = sum(fused.values())
    fused["stream_window_reads"] = (
        n_fields * (3 * n_in + n_out) * fb + fused["w_precompute"])

    # Whole state: per field the 3 private streams plus w amortized
    # 1/n_fields (the OpSpec's fractional fields_in), so w counts once.
    wplan = tiling.TilePlan(op=tiling.dycore_whole_state_spec(n_fields),
                            grid_shape=grid_shape, tile=(nz, ty, nx),
                            dtype=dn)
    whole = {
        "stream": n_fields * wplan.hbm_bytes_total,
        "w_precompute": 2 * fb,
    }
    whole["total"] = sum(whole.values())
    # three window fetches a private input a field; w's three once a window
    whole["stream_window_reads"] = (
        (n_fields * (3 * 3 + n_out) + 3) * fb + whole["w_precompute"])

    out = {"unfused": unfused, "fused": fused, "fused_whole": whole,
           "reduction_x": unfused["total"] / max(fused["total"], 1),
           "reduction_x_window_reads": (
               unfused["total"] / max(fused["stream_window_reads"], 1)),
           "reduction_x_whole": unfused["total"] / max(whole["total"], 1),
           "reduction_x_whole_window_reads": (
               unfused["total"] / max(whole["stream_window_reads"], 1)),
           "halo_overhead": plan.halo_overhead}

    if k_steps > 1:
        kspec = tiling.dycore_kstep_spec(n_fields, k_steps)
        kty = max(2, min(max(ty, k_steps * 2), ny))
        ksplan = tiling.TilePlan(op=kspec, grid_shape=grid_shape,
                                 tile=(nz, kty, nx), dtype=dn)
        # the carried state (field and stage, read and written) once a
        # ROUND here, once a STEP over k whole-state launches
        interstep = 4 * n_fields * fb
        kstep = {
            "stream": n_fields * ksplan.hbm_bytes_total + 2 * fb,
            "scan_total": k_steps * whole["total"],
            "scan_window_reads": k_steps * whole["stream_window_reads"],
            "interstep_state": interstep,
            "interstep_state_scan": k_steps * interstep,
        }
        kstep["total"] = kstep["stream"]
        out["fused_kstep"] = kstep
        out["interstep_reduction_x"] = (
            kstep["interstep_state_scan"] / max(kstep["interstep_state"], 1))
        out["reduction_x_kstep_vs_scan"] = (
            kstep["scan_total"] / max(kstep["total"], 1))
    return out


def packed_exchange_model(grid_shape, dtype, *, rides, k: int = 1,
                          shards=(2, 2), compute_halo=None,
                          exchange_dtype=None) -> Dict[str, float]:
    """The wire bytes of one depth-k stacked halo exchange, from the
    declared per-operand rides alone.

    `rides` holds `(name, count, (y_lo, y_hi), (x_lo, x_hi), (y_lo_fix,
    y_hi_fix), (x_lo_fix, x_hi_fix))`: `count` same-shaped tensors ride
    with per-side depth `k * base + fixed` (the fixed part: staggering
    columns that do not deepen with k, as wcon's right-only `+1`). A zero
    side ships nothing.

    Returns, per shard and per k timesteps: `bytes_kstep` (one deep
    exchange), `bytes_sequential` (k depth-1 rounds), `bytes_by_operand`,
    `bytes_ratio`, `rounds_kstep` / `rounds_sequential` (mesh directions
    with traffic) and `redundant_flops_frac` (the compute halo ring's
    extra work over the interior; `compute_halo` = (hy, hx), default the
    widest ride). Raises ValueError when a ride outgrows the local slab."""
    nz, ny, nx = (int(g) for g in grid_shape)
    py, px = shards
    ly, lx = ny // py, nx // px
    b = hw.dtype_bytes(exchange_dtype if exchange_dtype is not None
                       else dtype)

    def depth(base, fixed, kk):
        return (kk * base[0] + fixed[0], kk * base[1] + fixed[1])

    def operand_bytes(count, dy, dx):
        y = count * nz * (dy[0] + dy[1]) * lx * b
        x = count * nz * (dx[0] + dx[1]) * (ly + dy[0] + dy[1]) * b
        return int(y + x)

    def round_bytes(kk):
        return {name: operand_bytes(count, depth(ybase, yfix, kk),
                                    depth(xbase, xfix, kk))
                for name, count, ybase, xbase, yfix, xfix in rides}

    for name, count, ybase, xbase, yfix, xfix in rides:
        dy, dx = depth(ybase, yfix, k), depth(xbase, xfix, k)
        if max(dy) > ly or max(dx) > lx:
            raise ValueError(
                f"k={k} needs a ({max(dy)}, {max(dx)})-deep halo for "
                f"{name!r}; local slab ({ly}, {lx})")

    per_op = round_bytes(k)
    bytes_kstep = sum(per_op.values())
    bytes_seq = k * sum(round_bytes(1).values())
    y_active = any(sum(depth(yb, yf, k)) > 0
                   for _, _, yb, _, yf, _ in rides)
    x_active = any(sum(depth(xb, xf, k)) > 0
                   for _, _, _, xb, _, xf in rides)
    rounds = int(y_active) + int(x_active)
    if compute_halo is None:
        hy = max((depth(yb, yf, k)[1] for _, _, yb, _, yf, _ in rides),
                 default=0)
        hx = max((depth(xb, xf, k)[0] for _, _, _, xb, _, xf in rides),
                 default=0)
    else:
        hy, hx = compute_halo
    padded = (ly + 2 * hy) * (lx + 2 * hx)
    return {
        "bytes_kstep": bytes_kstep,
        "bytes_sequential": bytes_seq,
        "bytes_by_operand": per_op,
        "bytes_ratio": bytes_kstep / max(bytes_seq, 1),
        "rounds_kstep": rounds,
        "rounds_sequential": rounds * k,
        "redundant_flops_frac": padded / (ly * lx) - 1.0,
    }


def kstep_exchange_model(grid_shape, dtype, *, n_fields: int = 4,
                         k: int = 1, shards=(2, 2), halo: int = 2,
                         exchange_dtype=None) -> Dict[str, float]:
    """The fused dycore's k-step exchange: its declared footprint (the
    `3 * n_fields` field operands at depth `k * halo` both ways, wcon one
    column deeper on the right for its staggering) through
    `packed_exchange_model`, plus `bytes_wcon`. `exchange_dtype` models
    the wire cast; `shards` is (py, px)."""
    h = halo
    rides = (
        ("fields", 3 * n_fields, (h, h), (h, h), (0, 0), (0, 0)),
        ("wcon", 1, (h, h), (h, h), (0, 0), (0, 1)),
    )
    m = packed_exchange_model(grid_shape, dtype, rides=rides, k=k,
                              shards=shards, compute_halo=(k * h, k * h),
                              exchange_dtype=exchange_dtype)
    m["bytes_wcon"] = m["bytes_by_operand"]["wcon"]
    return m


def pipeline_step_traffic(chain_spec, stage_specs, grid_shape, dtype, *,
                          tile=None, k_steps: int = 1) -> Dict[str, float]:
    """A fused stage chain against its stages run one by one: the chain
    streams its operand union once a round (`chain_spec`), the sequence
    the sum of each stage's own traffic (`stage_specs`: `(OpSpec,
    n_fields)` pairs). Returns the chain's `stencil_op_traffic` plus
    `chained_per_round`, `sequential_per_round`, `sequential_by_stage` and
    `chained_reduction_x`.

    `chained_per_round` models a chain whose intermediates stay on chip.
    The port's chain (`weather/pipeline.py`) runs one kernel launch a
    stage (its stages' solo plans in order), so each stage's output goes
    through device memory before the next stage reads it: what it moves
    is nearer `sequential_per_round`."""
    n_chain = max(int(nf) for _, nf in stage_specs)
    out = stencil_op_traffic(chain_spec, grid_shape, dtype,
                             n_fields=n_chain, tile=tile, k_steps=k_steps)
    by_stage: Dict[str, int] = {}
    seq = 0
    for i, (spec, nf) in enumerate(stage_specs):
        t = stencil_op_traffic(spec, grid_shape, dtype, n_fields=int(nf),
                               tile=tile, k_steps=k_steps)
        label = spec.name
        if label in by_stage:
            label = f"{label}#{i}"
        by_stage[label] = t["stream_per_round"]
        seq += t["stream_per_round"]
    out["chained_per_round"] = out["stream_per_round"]
    out["sequential_per_round"] = int(seq)
    out["sequential_by_stage"] = by_stage
    out["chained_reduction_x"] = seq / max(out["stream_per_round"], 1)
    return out


def stencil_op_traffic(spec, grid_shape, dtype, *, n_fields: int = 1,
                       tile=None, k_steps: int = 1) -> Dict[str, float]:
    """Modelled main-memory bytes of one step of a stencil op from its
    `tiling.OpSpec` (streams in and out plus the window's halo) over a
    (z, y, x) `tile` window (default the whole grid): per-step stream
    bytes for `n_fields` fields, the ideal, the halo overhead, the flops,
    and a round's bytes at `k_steps` steps."""
    grid_shape = tuple(int(g) for g in grid_shape)
    if tile is None:
        tile = grid_shape
    plan = tiling.TilePlan(op=spec, grid_shape=grid_shape, tile=tuple(tile),
                           dtype=dtype_name(dtype))
    b = hw.dtype_bytes(dtype)
    ideal = int(spec.bytes_moved_per_point * b * math.prod(grid_shape))
    stream = plan.hbm_bytes_total
    return {
        "stream_per_field": stream,
        "stream": n_fields * stream,
        "stream_per_round": k_steps * n_fields * stream,
        "ideal": n_fields * ideal,
        "halo_overhead": plan.halo_overhead,
        "flops_per_step": n_fields * plan.flops_total,
    }


# ---------------------------------------------------------------------------
# the LM dry-run's memory estimate
# ---------------------------------------------------------------------------

def _jax_leaves(named: List[Tuple[Tuple[str, ...], bool, tuple, tuple,
                                  int]]):
    """The JAX package's leaves from the port's: (path, stacked, shape,
    spec, itemsize) a port tensor, where a stacked path's layers are one
    JAX leaf with a leading scan axis (its spec a leading None)."""
    out: Dict[Tuple[str, ...], list] = {}
    for path, stacked, shape, spec, itemsize in named:
        if not stacked:
            out[("#",) + path] = [tuple(shape), tuple(spec), itemsize]
        elif path in out:
            out[path][0] = (out[path][0][0] + 1,) + out[path][0][1:]
        else:
            out[path] = [(1,) + tuple(shape), (None,) + tuple(spec),
                         itemsize]
    return out.values()


def _shard_bytes(leaves, mesh) -> int:
    """Sum per-device bytes of (shape, spec, itemsize) leaves on `mesh`
    (the JAX package's arithmetic, float for float)."""
    from repro_torch.parallel.sharding import mesh_shape

    sizes = mesh_shape(mesh)
    total = 0
    for shape, spec, itemsize in leaves:
        n = 1
        for i, s in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            div = math.prod(sizes[a] for a in axes)
            s = -(-s // div)
            n *= s / shape[i]
        total += int(n * math.prod(shape)) * itemsize
    return total


def _param_leaves(params, specs):
    """A model's parameters (`Model.param_shapes()` will do) and their
    specs by name (`sharding.params_sharding`) as the JAX package's
    leaves."""
    from repro_torch.parallel.sharding import jax_path

    named = []
    for name, p in params.named_parameters():
        path, stacked = jax_path(params.cfg, name)
        named.append((path, stacked, tuple(p.shape), tuple(specs[name]),
                      p.element_size()))
    return _jax_leaves(named)


def _cache_leaves(cfg, cache, specs):
    """A cache (`Model.init_cache`, meta tensors will do) and its specs
    (`sharding.cache_sharding`) as the JAX package's leaves."""
    from repro_torch.parallel.sharding import _cache_path

    named = []
    if isinstance(cache, dict):                          # encoder-decoder
        for c, sp in zip(cache["dec"], specs["dec"]):
            for k, t in c.items():
                named.append((("dec", "self", k), True, tuple(t.shape),
                              tuple(sp[k]), t.element_size()))
        if "enc" in cache:
            t = cache["enc"]
            named.append((("enc",), False, tuple(t.shape),
                          tuple(specs["enc"]), t.element_size()))
    else:
        for i, (c, sp) in enumerate(zip(cache, specs)):
            prefix, stacked = _cache_path(cfg, i)
            for k, t in c.items():
                named.append((prefix + (k,), stacked, tuple(t.shape),
                              tuple(sp[k]), t.element_size()))
    return _jax_leaves(named)


def estimate(cfg, shape, mesh, p_shapes, p_shard, cache_shapes=None,
             cache_shard=None, *, microbatches: int = 1,
             xent_chunk: int = 512, spec=None) -> Dict[str, int]:
    """Analytic per-device bytes of a `shape` cell of `cfg` on `mesh` (a
    `DeviceMesh`, or the port's `Mesh`, which needs no process group):
    the JAX package's `estimate`, key for key. `p_shapes` is
    `Model.param_shapes()` and `p_shard` its specs by name
    (`params_sharding`); `cache_shapes` and `cache_shard` the cache and
    its specs (`cache_sharding`). Per device:

      train:   param shards + opt state (3x f32 shards) + grad shards (f32)
               + one (B, T, D) residual a remat carry / microbatches + a
               backward working set + xent chunk buffers;
      prefill: param shards + cache shards + ~2 layers of activations +
               the last logits;
      decode:  param shards + cache shards + O(B·d) vectors.

    `fits_16g` keeps the JAX package's key (its default spec's HBM is
    16 GiB); it means the total fits `spec`'s main memory, 80 GB on the
    default H100 spec."""
    from repro_torch.parallel import sharding as shd

    sizes = shd.mesh_shape(mesh)
    model_par = sizes.get("model", 1)
    b_axes = shd.batch_sharding(mesh, shape.global_batch)
    dp = 1
    if b_axes:
        axes = b_axes if isinstance(b_axes, tuple) else (b_axes,)
        dp = math.prod(sizes[a] for a in axes)
    b_loc = -(-shape.global_batch // dp)
    t = shape.seq_len
    d = cfg.d_model
    vocab_loc = -(-cfg.padded_vocab // model_par)

    params_b = _shard_bytes(_param_leaves(p_shapes, p_shard), mesh)
    out = {"params": params_b}

    if shape.kind == "train":
        out["opt_state"] = params_b * 2 * 3        # 3x f32 vs bf16 shards
        out["grads"] = params_b * 2                # f32 grad shards
        # remat=full checkpoints at pattern-period boundaries: one
        # (B, T, D) residual a period + the remainder blocks
        n_carries = cfg.n_repeats + cfg.n_remainder
        carry = n_carries * b_loc * (t // microbatches) * d * 2
        out["remat_carries"] = carry
        ff_loc = max(cfg.d_ff // model_par, d // model_par, 1)
        working = 6 * b_loc * (t // microbatches) * (d + ff_loc) * 4
        out["bwd_working_set"] = working
        out["xent"] = 2 * b_loc * min(xent_chunk, t) * vocab_loc * 4 * 2
    else:
        if cache_shapes is not None and cache_shard is not None:
            out["cache"] = _shard_bytes(
                _cache_leaves(cfg, cache_shapes, cache_shard), mesh)
        if shape.kind == "prefill":
            ff_loc = max(cfg.d_ff // model_par, d // model_par, 1)
            out["activations"] = 4 * b_loc * t * (d + ff_loc) * 2
            out["logits_tail"] = b_loc * vocab_loc * 4
        else:
            out["activations"] = 8 * b_loc * d * 4
            out["logits"] = b_loc * vocab_loc * 4

    out["total"] = sum(out.values())
    if spec is None:
        from repro_torch.core import hwspec
        spec = hwspec.default_spec()
    out["fits_16g"] = bool(out["total"] <= spec.main.capacity_bytes)
    return out
