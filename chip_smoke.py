#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --copy-times ROOT
    python3 chip_smoke.py --kernel-times ROOT
    python3 chip_smoke.py --examples
    torchrun --nproc-per-node 4 chip_smoke.py --train-mesh

In order: finds the card and prints its name and power limit; builds the
CUDA kernels from `src/repro_torch/csrc/` and shows with cuobjdump that the
bf16 flash and xent kernels issue HGMMA (wgmma), and prints the
whole-state dycore, k-step, LRU, hdiff stream, vadvc and hadv kernels'
ptxas registers and spills and the dycore, hdiff, vadvc and hadv kernels'
tiles; holds each kernel against its plain PyTorch
version on the card at the main path's shapes (float32 and bfloat16), and
two tilings of each against each other bit for bit (the whole-state kernel
also in clusters of one, at one field against its slice of the whole
state, at nz 2 to 1500, and its candidate tiles timed; the k-step kernels
also against k launches of their one-step kernels, hdiff's also at k = 4
and 9; the hdiff stream's candidate tiles timed; vadvc with the state's
periodic wcon and the staggered one bit for bit, and at nz 2, 3 and 1500;
hadv in its periodic mode, as the hadv_upwind plan runs it, and bit for
bit its passthrough mode on the wrap-padded stack, cropped); drives
the main path — `compile(StencilProgram(grid_shape=(64, 256, 256),
ensemble=4)).run(state, 10)` — in float32 and bfloat16, the hdiff and vadvc
plans, the k-step plans (`variant="kstep"`, `run(state, 5)`: full rounds and
a ragged tail) and the hadv_upwind plan, counting the kernel launches of
each run and comparing with the whole-state or unfused plan; the planner
(`compile(..., tune="measure")` of the main path in both dtypes, the hdiff,
vadvc and hadv_upwind plans and the dycore k=2 plan, with a fresh tuning
cache under build/: every candidate kernel tile timed, the pick's step
bit for bit and launch for launch equal to the default tile's, a second
compile measuring nothing and giving the same tile, `report()`'s analytic
model under h100_sxm and the modelled bytes over the measured step beside
it, and `hardware="power9"` modelling under that spec); the stage chains
(`PipelineProgram` of hadv_upwind -> vadvc_update -> hdiff in both dtypes:
3 launches a step, bit for bit its solo plans, near its unfused plan, the
k=2 round and `run(state, 5)`, the `vadvc_update` and `asselin` plans, an
`hdiff[u,v]` binding, and the chain step against the solo steps with
hdiff's pad and crop and a profiled split); drives the
`NeroEngine` entry point (plan + run of hdiff and vadvc at the paper's
domain in both dtypes and of copy, each equal to the direct kernel call bit
for bit; the measured "auto-tuned" pick beside the model's; the copy
kernel's sustained rate beside `Tensor.copy_`); then the LM serving path:
the flash-attention and LRU-scan kernels against their plain versions
(both models' prefill shapes, GQA, MQA at head_dim 256, window, softcap,
ragged T, T != S; float32, which runs the fp32-core flash kernel, and
bfloat16, which runs the tensor-core one), `ServeEngine` over
recurrentgemma-9b and tinyllama-1.1b at their full published widths and
depths with random bf16 weights (8 requests, 4 slots, 256-1024-token
prompts, 32 new tokens each; launch counts as planned, tokens equal to a
hand-rolled prefill + decode loop), the reduced configs on the card
against the CPU, and the times of prefill, decode and both kernels (flash
beside `scaled_dot_product_attention`); then the LM training path: the
cross-entropy kernel against its plain version (ragged N, padded vocab,
softcap, valid mask, both head layouts; float32 on the fp32-core kernel
and bfloat16 on the tensor-core one; both training shapes, bf16) and the
flash kernel at both training shapes (bf16: tensor cores), the
gradients of the xent (float32 and bfloat16), LRU and flash autograd
Functions against autograd of their plain versions, `train.loop.fit` over tinyllama-1.1b (full width
and depth, 5 steps) and recurrentgemma-9b (full width, 3 layers, 3 steps)
at batch 4 x 2048 in bf16 with `remat="full"` (launches as planned, finite
losses, moved parameters), tinyllama's step under `remat="none"`,
`"dots"` and `"full"` (time, peak memory: dots between the other two), a
reduced fp32 step on the card against the CPU, each step's time,
tokens/s, mfu, peak memory and a profiler split,
and the xent kernel's time at each training shape; then forecast
serving (phase 8): the slot-guard kernel against its plain version (a
lane-sized batch, clean and poisoned, fp32 and bf16, and each served
lane's own batch), `ForecastEngine` on 4 slots over the main path's
domain with a dycore fp32 lane, a bf16 lane, an `op="hdiff"` lane and a
pinned k=2 lane of ragged steps (every result bit-equal to its solo run,
one step kernel and one guard launch a lane round, no fallback, scrub or
divergence), the engine's steady round beside `plan.step` of the same
ensemble-4 plan with the device's share of it under the profiler, a
`poison_nan` fault quarantining one slot, an injected `compile_fail`
reaching the reference plan, a mid-drain checkpoint and restore bit-equal
to the uninterrupted drain, and reduced tinyllama `fit` with
`ckpt_every=2` resumed bit-equal to an uninterrupted run; then the LM
families (phase 9): the flash kernel at the prefill shapes of
whisper-medium's encoder (non-causal, 1500 frames), granite-moe-3b (GQA
group of 3), moonshot (head_dim 128) and qwen2-vl (group of 8) against
its plain version and timed beside SDPA,
`ServeEngine` over granite-moe-3b, moonshot-v1-16b, mamba2-1.3b,
whisper-medium and qwen2-vl-72b at full width in bf16 (moonshot and
qwen2-vl cut in depth to about 30 GB of weights) with the same requests as
phase 6 (launches as planned, tokens equal to a stepwise loop, a profiler
split with the MoE dispatch/combine and SSD scan ranges), `fit` over
granite-moe-3b at full width and depth (3 steps), and each family's
reduced fp32 step on the card against the CPU; then the weather plans on
a mesh (phase 10): `make_mesh((2, 2), ("data", "model"), devices=[cuda:0]
* 4)`, four shards on this ONE card (so no interconnect is measured), the
main path's `run(state, 10)` in fp32, bf16 and with a bf16 exchange wire,
each against the single-device plan's (the reference's distributed
tolerance; the wire run within its halo-confined bound), one whole-state
launch a shard a round and the report's rides, the resolved k's round (or
a pinned k=2) against k whole-state mesh rounds, one round of the hdiff,
vadvc, hadv_upwind, vadvc_update, asselin and flagship-chain mesh plans
against their single-device plans (the chain also bit for bit against its
stages' own mesh plans in sequence, and timed beside them), the mesh
round beside the
single-device step (by call and queued) and the exchange's device and
host share under `torch.profiler`; then the forecast engine on that mesh
(phase 11): the slot-guard kernel with each shard's offset against its
plain version and the combined digest against the single-device kernel's
(fp32, bf16, timed a shard and whole), `ForecastEngine(mesh=)` serving a
dycore fp32 lane, a bf16 lane and an `op="hdiff"` lane (every result
bit-equal to its solo mesh run and the single-device plan's at the lane's
round strategy; one step kernel a shard and the guard's 4 + 1 launches a
lane round), a
persistent loss of logical device 3 failing over (2, 2) -> (2, 1) with
every request bit-equal, a `wire_corrupt` of a rolled-back slot
quarantined, a mid-drain checkpoint restored onto one device and onto
(4, 1) bit-equal, and the steady mesh round, the guard's share, admit,
retire and the failover's reshard; then LM training on a device mesh
(phase 12): a (1, 1) `DeviceMesh` over NCCL (a world of one), on which
`fit(mesh=)` trains tinyllama-1.1b in full and recurrentgemma-9b at full
width cut to phase 7's 3 layers for 3 steps with phase 7's seed and
settings, parameters, optimizer state and batches DTensors placed by the
rule table, each run bit for bit the same run on one device (losses, grad
norms, parameters) and phase 7's losses, with phase 7's flash, LRU and
xent launches a step through the DTensor seams and the step beside the
one-device step (the DTensor overhead); reduced fp32 mesh steps on the
card against the CPU; a `seq_shard` step on the (1, 1) mesh bit for bit
the step without it; the int8 codec and `compressed_psum` on the card;
then the dry-run against the card (phase 13): phase 7's two training
cells traced as rank 0 of a fake world of one (`launch/dryrun.py`, in a
subprocess that sees no card), each kernel's traced calls equal to its
launches in one of phase 7's steps, the roofline bound at or under
phase 7's measured step and the fake live peak within 0.75-1.05 of the
card's peak, the analytic estimate printed beside them; then the port's
examples (phase 14, `examples_phase`): each `examples/torch_*.py` on the
card in a subprocess, exit 0 and its `OK` line required and its own
`kernel launches` line read (the quickstart's kernel-vs-plain errors
within the kernel tests' tolerances; the weather example at the main
path's domain and ensemble on one device and on a (2, 2) mesh listing the
card 4 times, their final energies equal; the forecast service plain,
under `--chaos` and in the `--kill-device 3` drill, bit for bit; LM
training for its default 200 steps and a resume of 10 more from the
checkpoint; LM serving),
each run's host seconds and the weather run's ms a step beside phase 4's
step; times every kernel,
its plain version, one main-path step and one k-step round with CUDA
events (each stencil kernel and copy also queued back to back; the k-step
round beside k whole-state launches; copy and `Tensor.copy_` also under
`torch.profiler`); prints one JSON `kernels` line, then the result line.
Any failure exits nonzero. Imports nothing of JAX.

`--examples` runs phase 14 alone (`examples_main`) and prints no result
line. With `--copy-times ROOT` it only times the copy kernel of the checkout at
ROOT as phase 5 times this one's (`copy_times_of`), to hold two commits'
kernels against each other on one card, and prints no result line.
`--kernel-times ROOT` (`kernel_times_of`) does the same for copy, the
whole-state dycore kernel (also at one field), the dycore k-step rounds
(k = 1, 2, 3), hdiff and its k-step rounds (k = 2, 3, 4, 9), vadvc (a
staggered wcon) and hadv (passthrough, on the padded stack), one main-path
step with its `run(state, 10)` peak memory, one `op="hdiff"` step and the
k=2 hdiff plan's `run(state, 5)`, one `op="vadvc"` and one
`op="hadv_upwind"` step and the hadv plan's `run(state, 5)`, and the LRU
sweep (forward and reverse), fp32 and bf16, each output hashed so two
checkouts' bits can be compared: run parent, change, change, parent in
one call.

`torchrun --nproc-per-node 4 chip_smoke.py --train-mesh` (four cards,
one process each, NCCL; `train_mesh_main`) runs the reduced families'
fp32 steps on (2, 2) and (1, 4) against a one-card step, each also with
sequence parallelism (`seq_shard`), the codec over a 2-rank axis, and
tinyllama-1.1b and recurrentgemma-9b at full width and depth (38 layers)
in bf16 at 4 x 2048, remat "full", 3 steps on (2, 2), without and with
`seq_shard`: launches a rank, each first loss against a forward-only
`model.loss` on one card and its first gradient norm against one card's
backward, peak memory a card, step ms, tokens/s, mfu and rank 0's device
idle share; then rank 0's dry-run trace of the four cells on a (2, 2)
fake world, held to the same three gates as phase 13's, its
roofline_fraction beside the measured mfu; and `launch/train.py` itself
on `--mesh 2,2` and on the ("pod", "data", "model") mesh `--mesh 2,1,2`
(tinyllama-1.1b at full width, 3 steps at 4 x 2048, bf16), the pod run's
losses and grad norms held to the (2, 2) run's and said bit-equal or not.
It prints no result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GRID = (64, 256, 256)          # the paper's full domain (nz, ny, nx)
ENSEMBLE = 4
STEPS = 10
REPS = 20                      # timed launches per median
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
LOOSE = 0.05                   # |coeff·flux| bound at a flipped limiter branch
BF16_RTOL = 2.0 ** -7          # twice bf16's unit roundoff: one rounding
KSTEPS = (2, 3)                # k-step rounds checked; the k-step path runs 2
# hdiff k-step rounds longer than a launch runs, checked and timed: 4, two
# launches of 2 stages, and 9, three of 3
LONG_KSTEPS = (4, 9)
DEPTHS = (2, 9, 37, 96, 1500)  # nz of the whole-state kernel's depth checks
VADVC_DEPTHS = (2, 3, 1500)    # nz of the vadvc kernel's depth checks
PATH_STEPS = 5                 # k-step path: full rounds and a ragged tail
# the flagship stage chain of phase 4c (pipelines)
PIPELINE = ("hadv_upwind", "vadvc_update", "hdiff")
# phase 10 (mesh): a ("data", "model") mesh of this shape, every shard on
# the one card; the op plans run a round there beside the main path, each
# held to its single-device plan at its kernel's tolerance (the flagship
# chain: at most 2 points a tensor over it, where a limiter may flip)
MESH_SHAPE = (2, 2)
MESH_OPS = ("hdiff", "vadvc", "hadv_upwind", "vadvc_update", "asselin")
MESH_TOL = {"hdiff": 1e-5, "vadvc": 2e-4, "hadv_upwind": 1e-5,
            "vadvc_update": 2e-4, "asselin": 1e-5, "flagship": 2e-4}
# phase 7: a tinyllama step under each remat mode, REMAT_STEPS timed
REMATS = ("none", "dots", "full")
REMAT_STEPS = 3
# phase 12: LM training on a (1, 1) DeviceMesh, each of TRAIN_RUNS for
# this many steps on the mesh and on one device
TRAIN_MESH_STEPS = 3
# the copy's two sizes, as (rows, 256) float32: the paper's domain (16.8 MB,
# L2-resident) and the main path's field-stacked state (268 MB)
COPY_SIZES = (("paper domain", GRID[0] * GRID[1]),
              ("field-stacked state", ENSEMBLE * 4 * GRID[0] * GRID[1]))
SERVE_ARCHS = ("recurrentgemma-9b", "tinyllama-1.1b")   # full width, bf16
# the flash kernel's timed case at each of SERVE_ARCHS' prefill shapes, in
# that order: (case label, results key)
FLASH_TIMES = (("recurrentgemma prefill", "flash_attn"),
               ("tinyllama prefill (GQA g=8)", "flash_attn_tinyllama"))
SERVE_REQUESTS = 8
SERVE_SLOTS = 4
SERVE_NEW = 32                 # new tokens a request
PROMPT_LENS = (256, 1024)      # prompt lengths, drawn from a seed
# LM training: (arch, layers kept (0: all), steps); full width, bf16
TRAIN_RUNS = (("tinyllama-1.1b", 0, 5), ("recurrentgemma-9b", 3, 3))
TRAIN_BATCH, TRAIN_SEQ = 4, 2048      # tinyllama's published context
# LM families (phase 9): the five configurations phases 6-7 do not run,
# served at full width in bf16. A config whose bf16 weights (its
# param_count) exceed FAMILY_WEIGHTS_GB keeps the most layers that fit,
# at least FAMILY_MIN_LAYERS; FAMILY_TRAIN trains at full width and depth.
FAMILY_ARCHS = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-1.3b",
                "whisper-medium", "qwen2-vl-72b")
FAMILY_WEIGHTS_GB = 30
FAMILY_MIN_LAYERS = 8
FAMILY_TRAIN = ("granite-moe-3b-a800m", 3)          # arch, steps
# the planner phase's plans, each compiled with tune="measure":
# (op, variant, k_steps, dtype)
PLANNER_PLANS = (("dycore", "auto", "auto", "float32"),
                 ("dycore", "auto", "auto", "bfloat16"),
                 ("hdiff", "auto", "auto", "float32"),
                 ("vadvc", "auto", "auto", "float32"),
                 ("hadv_upwind", "auto", "auto", "float32"),
                 ("dycore", "kstep", 2, "float32"))


# forecast serving (phase 8): a dycore lane's requests in each dtype, their
# steps drawn from a seed in FORECAST_STEPS, and the pinned k=2 lane's
# ragged steps; the steady-round timing's requests and rounds
FORECAST_REQUESTS = 8
FORECAST_STEPS = (2, 8)
KSTEP_STEPS = (3, 6, 5, 2)
STEADY_ROUNDS = 20
PROFILED_ROUNDS = 10
STEADY_STEPS = STEADY_ROUNDS + PROFILED_ROUNDS + 4
# phase 11 (forecast on a mesh): the steady mesh rounds timed on the host
# clock and under the profiler; the requests' steps leave room for k <= 3
MESH_STEADY_ROUNDS = 15
MESH_PROFILED_ROUNDS = 5
MESH_STEADY_STEPS = 3 * (MESH_STEADY_ROUNDS + MESH_PROFILED_ROUNDS + 2)


class SmokeFailure(Exception):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def times_ms(fn, reps: int = REPS) -> list:
    """CUDA-event times of `fn()` over `reps` calls, after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of `fn()` over `reps` calls, after warm-up."""
    return statistics.median(times_ms(fn, reps))


def stream_ms(fn, n: int = 50) -> float:
    """Mean CUDA-event time of `n` calls of `fn()` queued back to back,
    after warm-up: the host's launch overhead hides behind the kernels
    whenever a kernel outlasts it."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n: int = 20):
    """Mean device time of one `fn()` under `torch.profiler`, after
    warm-up: the summed durations of the device kernels and copies of `n`
    calls, over `n`. None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / n / 1e3 if total else None


def copy_times(copy_fn, src) -> dict:
    """A copy kernel's `copy_fn(src)` and `Tensor.copy_` into a preallocated
    tensor, each timed three ways: events around one call (the wrapper's
    host path included), calls queued back to back, and the device's own
    time under the profiler."""
    import torch

    dst = torch.empty_like(src)
    kernel = lambda: copy_fn(src)
    library = lambda: dst.copy_(src)
    return dict(ms=time_ms(kernel), queued_ms=stream_ms(kernel),
                profiler_ms=device_ms(kernel), library_ms=time_ms(library),
                library_queued_ms=stream_ms(library),
                library_profiler_ms=device_ms(library))


def _import_root(root: Path):
    """Import the `repro_torch` package of the checkout at ROOT (another
    commit, unpacked with `git archive`, or this one) and build its
    kernels."""
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    require(Path(_build.__file__).resolve().is_relative_to(root),
            f"imported {_build.__file__}, not the package under {root}")
    _build.load()


def _copy_times_at(root: Path) -> dict:
    """ROOT's copy kernel checked bit for bit and timed as phase 5 times
    this checkout's, at both of its sizes."""
    import torch

    from repro_torch.kernels.copy_stencil.copy_stencil import copy_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, rows in COPY_SIZES:
        src = torch.randn(rows, GRID[2], generator=gen, device="cuda")
        require(torch.equal(copy_cuda(src).view(torch.int32),
                            src.view(torch.int32)),
                f"{root}: the copy differs at {label}")
        out[label] = copy_times(copy_cuda, src)
        del src
    return out


def copy_times_of(root: Path) -> int:
    """`python3 chip_smoke.py --copy-times ROOT`: the copy kernel of the
    checkout at ROOT checked bit for bit and timed as phase 5 times this
    checkout's, at both of its sizes; one JSON line. Holds one commit's
    kernel against another's on one card: run parent, change, change,
    parent in one call."""
    root = root.resolve()
    _import_root(root)
    say(json.dumps({"copy_times": str(root), "sizes": _copy_times_at(root)}))
    return 0


def digest(*tensors) -> str:
    """A short hash of the tensors' bits: equal hashes from two checkouts'
    kernels on the same inputs mean equal outputs, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                                   else torch.int32)
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_times_of(root: Path) -> int:
    """`python3 chip_smoke.py --kernel-times ROOT`: the copy, dycore, hdiff,
    vadvc, hadv and LRU kernels of the checkout at ROOT, built from ROOT's sources and
    timed at the main path's shapes, each beside a hash of its output on
    inputs made from fixed seeds (equal hashes between two checkouts: the
    same bits): copy as `--copy-times` times it; the whole-state dycore
    kernel at (4, 4, 64, 256, 256) and at one field, fp32 and bf16, per
    call and queued, on ROOT's default tiles; the dycore k-step rounds at
    k = 1, 2, 3; hdiff at (1024, 260, 260) and its k-step rounds at k = 2,
    3, 4, 9 on their padded stacks, per call and queued, on the wrappers' default
    tiles; vadvc at (4, 4, 64, 256, 256) with a staggered wcon and hadv in
    passthrough mode at (1024, 257, 257), per call and queued; one main-path
    step (`ExecutionPlan.step`) and the peak device memory of a main-path
    `run(state, 10)`; one `op="hdiff"` whole-state step and the k=2 hdiff
    plan's `run(state, 5)`; one `op="vadvc"` and one `op="hadv_upwind"`
    step and the hadv plan's `run(state, 5)`; the LRU sweep forward at
    (4, 1024, 4096) and reverse at (4, 2048, 4096), fp32 and bf16, per call
    and queued. One JSON line. Run parent, change, change, parent in one
    call."""
    import torch

    root = root.resolve()
    _import_root(root)
    from repro_torch.core import tiling
    from repro_torch.kernels.dycore_fused import ops as fused_ops
    from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
    from repro_torch.kernels.dycore_fused.kstep import (
        fused_dycore_kstep_cuda)
    from repro_torch.kernels.dycore_fused.ref import pad_periodic
    from repro_torch.kernels.hadv.hadv import hadv_cuda
    from repro_torch.kernels.hdiff.hdiff import hdiff_cuda, hdiff_kstep_cuda
    from repro_torch.kernels.lru_scan.lru_scan import lru_scan_cuda
    from repro_torch.kernels.vadvc.vadvc import vadvc_cuda
    from repro_torch.weather import fields
    from repro_torch.weather.program import StencilProgram, compile

    dev = torch.device("cuda")
    out = {"copy": _copy_times_at(root)}
    ny, nx = GRID[1:]
    nf = len(fields.PROGNOSTIC)

    def timed(fn, reps=REPS, queued=50):
        return dict(ms=time_ms(fn, reps), queued_ms=stream_ms(fn, queued))

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = lambda scale, *shape: (scale * torch.randn(
            shape, generator=gen, device=dev)).to(dtype)
        fs = noise(1.0, ENSEMBLE, nf, *GRID)
        ts = noise(0.01, ENSEMBLE, nf, *GRID)
        ss = noise(0.01, ENSEMBLE, nf, *GRID)
        w = fused_ops.staggered_w(noise(0.05, ENSEMBLE, *GRID))
        # each wrapper's default tile for these fields
        r = out[f"dycore_fused {dn}"] = timed(
            lambda: fused_dycore_cuda(fs, w, ts, ss))
        r["hash"] = digest(*fused_dycore_cuda(fs, w, ts, ss))
        one = [a[:, :1].contiguous() for a in (fs, ts, ss)]
        r = out[f"dycore_fused one field {dn}"] = timed(
            lambda: fused_dycore_cuda(one[0], w, one[1], one[2]))
        r["hash"] = digest(*fused_dycore_cuda(one[0], w, one[1], one[2]))
        del one
        for k in (1,) + KSTEPS:
            tile = tiling.dycore_kstep_tile(ny, nx, k, nz=GRID[0])
            run = lambda: fused_dycore_kstep_cuda(fs, w, ts, ss, k_steps=k,
                                                  tile=tile)
            r = out[f"dycore_kstep k={k} {dn}"] = timed(run, queued=20)
            r["hash"] = digest(*run())
            r["tile"] = [tile.ty, tile.tx, tile.cluster, tile.rows]
        # hdiff on the field-stacked state wrap-padded by 2 (one step) and
        # by 2k (the k-step rounds), on the wrappers' default tiles
        for k in (1,) + KSTEPS + LONG_KSTEPS:
            src = pad_periodic(fs, 2 * k).reshape(-1, ny + 4 * k, nx + 4 * k)
            run = ((lambda: hdiff_cuda(src)) if k == 1 else
                   (lambda: hdiff_kstep_cuda(src, k_steps=k)))
            key = "hdiff" if k == 1 else f"hdiff_kstep k={k}"
            r = out[f"{key} {dn} {tuple(src.shape)}"] = timed(run)
            r["hash"] = digest(run())
            del src
        # vadvc with a staggered wcon, as every checkout takes it; hadv in
        # passthrough mode on the stack wrap-padded by 1 on the low sides
        wst = noise(0.15, ENSEMBLE, *GRID[:2], GRID[2] + 1)
        run = lambda: vadvc_cuda(fs, wst, fs, ts, ss)
        r = out[f"vadvc {dn} {tuple(fs.shape)}"] = timed(run)
        r["hash"] = digest(run())
        src = torch.cat([fs[..., -1:, :], fs], dim=-2)
        src = torch.cat([src[..., :, -1:], src], dim=-1).reshape(
            -1, ny + 1, nx + 1)
        run = lambda: hadv_cuda(src)
        r = out[f"hadv {dn} {tuple(src.shape)}"] = timed(run)
        r["hash"] = digest(run())
        del fs, ts, ss, w, wst, src
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(2)
        st = fields.initial_state(gen, GRID, ENSEMBLE, dtype=dtype,
                                  device=dev)
        plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                      dtype=dn))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        end = plan.run(st, STEPS)
        torch.cuda.synchronize()
        out[f"main path {dn}"] = dict(
            step_ms=time_ms(lambda: plan.step(st)),
            run_peak_bytes=torch.cuda.max_memory_allocated(),
            run_peak_above_state_bytes=torch.cuda.max_memory_allocated()
            - base,
            hash=digest(*(end.fields[n] for n in end.fields)))
        # the hdiff op: one whole-state step, and the k=2 plan's
        # run(state, 5) (two k-step rounds and a one-step tail)
        plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                      op="hdiff", dtype=dn))
        nxt = plan.step(st)
        out[f"op=hdiff step {dn}"] = dict(
            step_ms=time_ms(lambda: plan.step(st)),
            hash=digest(*(nxt.fields[n] for n in nxt.fields)))
        plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                      op="hdiff", dtype=dn, variant="kstep",
                                      k_steps=2))
        end = plan.run(st, PATH_STEPS)
        out[f"op=hdiff k=2 run({PATH_STEPS}) {dn}"] = dict(
            ms=time_ms(lambda: plan.run(st, PATH_STEPS)),
            hash=digest(*(end.fields[n] for n in end.fields)))
        # one whole-state step of the vadvc and hadv_upwind ops, and the
        # hadv plan's run(state, 5)
        for op in ("vadvc", "hadv_upwind"):
            plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                          op=op, dtype=dn))
            nxt = plan.step(st)
            out[f"op={op} step {dn}"] = dict(
                step_ms=time_ms(lambda: plan.step(st)),
                hash=digest(*(getattr(nxt, part)[n] for part in
                              ("fields", "stage_tens") for n in nxt.fields)))
        end = plan.run(st, PATH_STEPS)
        out[f"op=hadv_upwind run({PATH_STEPS}) {dn}"] = dict(
            ms=time_ms(lambda: plan.run(st, PATH_STEPS)),
            hash=digest(*(end.fields[n] for n in end.fields)))
        del st, end, nxt, plan
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(3)
        for label, shape, reverse in (("forward", (4, 1024, 4096), False),
                                      ("reverse", (4, 2048, 4096), True)):
            a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=dev)
                 ).to(dtype)
            b = torch.randn(shape, generator=gen, device=dev).to(dtype)
            run = lambda: lru_scan_cuda(a, b, reverse=reverse)
            r = out[f"lru_scan {label} {dn} {shape}"] = timed(run)
            r["hash"] = digest(run())
            del a, b
        torch.cuda.empty_cache()
    for key, r in out.items():
        say(f"kernel times {root.name}: {key}: {json.dumps(r)}")
    say(json.dumps({"kernel_times": str(root), "results": out}))
    return 0


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(got, want, rtol):
    """|got − want| ≤ 2e-5 + rtol·|want| everywhere (fp32: rtol 2e-5, the
    JAX kernel tests' tolerance; bf16 adds one rounding of the output,
    2^-8·|want|); returns (ok, max abs err)."""
    d = (got.float() - want).abs()
    return bool((d <= 2e-5 + rtol * want.abs()).all()), float(d.max())


def time_flash(torch, results, key, label, q, k, v, err, causal):
    """The flash kernel at q, k, v (bf16, as the models run) by call and
    queued, beside its plain version and SDPA, the library yardstick,
    which the port never calls; stored under `results[(key,
    "bfloat16")]`."""
    from repro_torch.kernels.flash_attention import flash as flash_k
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, t, h, hd = q.shape
    ms = time_ms(lambda: flash_ops.flash_mha(q, k, v, causal=causal))
    plain_ms = time_ms(lambda: flash_ref.mha(q, k, v, causal=causal))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                      enable_gqa=True))
    # queued back to back: the wrapper's host path hides behind the
    # kernels, so these are the device's times
    queued_ms = stream_ms(lambda: flash_ops.flash_mha(q, k, v,
                                                      causal=causal))
    library_queued_ms = stream_ms(lambda: sdpa(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    flops = flash_k.attention_flops(b, t, k.shape[1], h, hd, causal=causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    results[(key, "bfloat16")] = dict(
        err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=b_ms, bound_by=b_by, shape=[list(q.shape), list(k.shape)],
        tflops=flops / ms * 1e-9, queued_ms=queued_ms,
        library_queued_ms=library_queued_ms, causal=causal)
    say(f"flash {label} {tuple(q.shape)}/{tuple(k.shape)} bf16: "
        f"{ms:.4f} ms = {flops / ms * 1e-9:.2f} TFLOP/s (plain "
        f"{plain_ms:.3f} ms, SDPA {library_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms by {b_by}); queued back to back {queued_ms:.4f} ms = "
        f"{flops / queued_ms * 1e-9:.2f} TFLOP/s, SDPA "
        f"{library_queued_ms:.4f} ms")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_category(name: str) -> str:
    """The group a device kernel's time is reported under."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attn"
    if "lru_scan" in n:
        return "lru_scan"
    if "xent_partial" in n or "xent_combine" in n:
        return "xent"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


# the port's profiler ranges (`torch.profiler.record_function`): MoE routing
# and dispatch, its combine, and the SSD scan; a kernel launched inside one
# is reported under its name
RANGES = ("moe_dispatch", "moe_combine", "ssd_scan", "halo_exchange")
# the port's own kernels (`kernel_category`'s, `mesh_category`'s and
# `pipeline_category`'s groups): launched through ctypes, so they go by name
PORT_KERNELS = ("flash_attn", "lru_scan", "xent", "dycore_fused",
                "dycore_kstep", "hdiff", "vadvc", "hadv", "slot_guard")


def device_breakdown(fn, category=kernel_category):
    """Run `fn()` under `torch.profiler` and read its device kernels:
    the host window (ms, profiler on, ending in a synchronise), the union
    of kernel intervals (busy ms), the idle share of the window, and the
    kernel time by group: the `RANGES` range the kernel was launched in
    (the range around its launching operator on that thread, or else the
    range's device-side span), else `category` of its name; the host time
    spent inside each range (`host_range_ms`); and the seconds the
    profiler's events took to read. The raw events are read
    (`kineto_results`), not `prof.events()`, whose tree of Python objects
    takes tens of seconds at a training step's 10^5 kernels. None when
    the profiler saw no device kernel."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    kernels, dev_ranges, ops, cpu_ranges = [], [], {}, {}
    no = lambda: False              # a method older releases lack
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", no)():
            continue
        name = e.name()
        if e.device_type() == cuda:
            if name in RANGES:
                dev_ranges.append((e.start_ns(), e.end_ns(), name))
            elif not getattr(e, "is_user_annotation", no)():
                kernels.append((e.start_ns(), e.end_ns(), name,
                                e.linked_correlation_id()))
        elif name in RANGES:
            cpu_ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), name))
        elif e.linked_correlation_id() == 0:      # an operator, not runtime
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    dev_ranges.sort()
    host_range_ms = {}
    for rs in cpu_ranges.values():
        rs.sort()
        for start, end, name in rs:
            host_range_ms[name] = host_range_ms.get(name, 0.0) + \
                (end - start) / 1e6

    def inside(rs, at):
        """The name of the range of sorted, unnested `rs` holding `at`."""
        i = bisect.bisect_right(rs, (at, float("inf"), "")) - 1
        return rs[i][2] if i >= 0 and at <= rs[i][1] else None

    def group(start, name, corr):
        # the port's own kernels go by name: launched through ctypes, no
        # operator encloses them, so their launcher's id is a stale one
        cat = category(name)
        if cat in PORT_KERNELS:
            return cat
        op = ops.get(corr)
        found = (inside(cpu_ranges[op[1]], op[0])
                 if op is not None and op[1] in cpu_ranges else None)
        return found or inside(dev_ranges, start) or cat

    spans = sorted((start, end, group(start, name, corr))
                   for start, end, name, corr in kernels)
    if not spans:
        return None
    busy, (lo, hi) = 0, spans[0][:2]
    by = {}
    for start, end, cat in spans:
        by[cat] = by.get(cat, 0.0) + (end - start) / 1e6
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy_ms = (busy + hi - lo) / 1e6
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, kernels=len(spans),
                host_range_ms=host_range_ms,
                by_category_ms=dict(sorted(by.items(),
                                           key=lambda kv: -kv[1])),
                read_s=time.perf_counter() - t0)


def pipeline_category(name: str) -> str:
    """The group a device kernel of a stage chain's round is reported
    under: each stage kernel, hdiff's wrap pad (the round's only copies:
    `torch.cat` of strided slices runs as copy kernels), the point-wise
    update."""
    n = name.lower()
    for kernel in ("hdiff_stream", "vadvc_stream", "hadv_stream"):
        if kernel in n:
            return kernel.split("_")[0]
    if "cat" in n or "copy" in n:
        return "pad"
    if "mul" in n or "add" in n:
        return "update"
    return "other"


def serve_prompts(cfg):
    """SERVE_REQUESTS prompts of PROMPT_LENS tokens, from seed 0: every
    model serves the same lengths."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                  size=SERVE_REQUESTS)]


def serve_model(torch, dev, check, results, model, params, n_attn, n_rec,
                n_dec=8):
    """`ServeEngine` over SERVE_REQUESTS requests on SERVE_SLOTS slots with
    the planned launches (a wave's prefill launches flash `n_attn` times
    and the LRU `n_rec` times, each decode step the LRU `n_rec` times),
    its first wave equal to a hand-rolled prefill + decode loop, a
    profiled prefill and `n_dec` decode steps, and the engine's times, under
    `results[("serve_<name>", dtype)]` and `("profile_<name>", dtype)`.
    Returns the run's flash and LRU launches."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.models.common import torch_dtype
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    arch = cfg.name
    n_params = sum(p.numel() for p in params.parameters())
    prompts = serve_prompts(cfg)
    plen = max(len(p) for p in prompts)
    max_len = plen + SERVE_NEW
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(model, params, batch=SERVE_SLOTS, max_len=max_len)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    want = {k: 0 for k in counts}
    want["flash_attn"] = waves * n_attn
    want["lru_scan"] = waves * n_rec * SERVE_NEW   # prefill + 31 steps
    label = f"serve {arch}"
    say(f"{label}: {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}), {SERVE_REQUESTS} requests, "
        f"{SERVE_SLOTS} slots, prompts {min(map(len, prompts))}-{plen} "
        f"tokens (padded to {plen}), {SERVE_NEW} new each; launches "
        f"{counts} (planned {want})")
    check(counts == want, f"{label}: launched {counts}, planned {want}")
    check(sorted(out) == list(range(SERVE_REQUESTS))
          and all(len(v) == SERVE_NEW for v in out.values()),
          f"{label}: not every request got {SERVE_NEW} tokens")
    check(all(0 <= t < cfg.vocab_size for v in out.values() for t in v),
          f"{label}: a token outside the vocab")

    # The first wave again by hand: prefill + decode_step, greedy, the
    # same left-padded batch; flash launches only in the prefill.
    toks = np.zeros((SERVE_SLOTS, plen), np.int64)
    for i, r in enumerate(reqs[:SERVE_SLOTS]):
        toks[i, plen - len(r.prompt):] = r.prompt
    wave = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.encdec:                   # the engine's zero frames
        wave["frames"] = torch.zeros(
            (SERVE_SLOTS, cfg.encdec.encoder_len, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=dev)
    with torch.inference_mode():
        _build.reset_launches()
        logits, cache = model.prefill(params, wave, max_len=max_len)
        nxt = logits[:, -1].argmax(dim=-1)
        finite = bool(torch.isfinite(logits[:, -1]).all())
        del logits
        torch.cuda.synchronize()
        after_prefill = dict(_build.LAUNCHES)
        hand = [nxt.cpu()]
        for step in range(SERVE_NEW - 1):
            lg, cache = model.decode_step(params, cache, nxt[:, None],
                                          plen + step)
            finite &= bool(torch.isfinite(lg).all())
            nxt = lg[:, -1].argmax(dim=-1)
            hand.append(nxt.cpu())
        del cache, lg
    torch.cuda.synchronize()
    after_decode = dict(_build.LAUNCHES)
    hand = torch.stack(hand, dim=1).tolist()
    same = all(out[i] == hand[i] for i in range(SERVE_SLOTS))
    say(f"{label}: engine vs hand-rolled loop, wave 1: "
        f"{'equal token for token' if same else 'DIFFERENT'}; launches "
        f"after prefill {after_prefill['flash_attn']} flash, "
        f"{after_prefill['lru_scan']} lru; after {SERVE_NEW - 1} decode "
        f"steps {after_decode['flash_attn']} flash, "
        f"{after_decode['lru_scan']} lru; logits finite {finite}")
    check(same, f"{label}: the engine differs from its stepwise loop")
    check(finite, f"{label}: non-finite logits")
    check(after_prefill["flash_attn"] == n_attn
          and after_prefill["lru_scan"] == n_rec
          and after_decode["flash_attn"] == n_attn
          and after_decode["lru_scan"] == n_rec * SERVE_NEW,
          f"{label}: stepwise launches {after_prefill} then "
          f"{after_decode}")

    # Where the device time goes: one wave's prefill, then n_dec decode
    # steps (fewer if the cache would not hold them), each under the
    # profiler.
    n_dec = min(n_dec, SERVE_NEW - 1)
    with torch.inference_mode():
        holder = {}

        def prefill():
            holder["lg"], holder["cache"] = model.prefill(
                params, wave, max_len=max_len)
            holder["nxt"] = holder["lg"][:, -1:].argmax(dim=-1)

        def decode():
            for step in range(n_dec):
                lg, holder["cache"] = model.decode_step(
                    params, holder["cache"], holder["nxt"], plen + step)
                holder["nxt"] = lg[:, -1:].argmax(dim=-1)

        prof = {"prefill": device_breakdown(prefill)}
        del holder["lg"]
        prof[f"decode_{n_dec}_steps"] = device_breakdown(decode)
        del holder
    results[(f"profile_{arch}", cfg.dtype)] = prof
    for part, br in prof.items():
        if br is None:
            say(f"{label} {part}: the profiler saw no device kernel "
                f"(device breakdown not measured)")
            continue
        say(f"{label} {part} under torch.profiler: host window "
            f"{br['wall_ms']:.2f} ms, device busy {br['busy_ms']:.2f} ms "
            f"(idle share {br['idle_share']:.3f}), {br['kernels']} "
            f"kernels (read in {br['read_s']:.1f} s); by kind (ms) "
            + ", ".join(f"{k} {v:.2f}"
                        for k, v in br["by_category_ms"].items()))

    # ---- (c) times: the engine's host clock, which each wave's
    # sampling synchronises
    pre = eng.stats["prefill_s"]
    dec = eng.stats["decode_s"]
    # prompt tokens/s over every wave (padded tokens: what the device
    # computes); the first wave also pays for the library's first calls
    # at these shapes
    prompt_tps = SERVE_SLOTS * plen * len(pre) / sum(pre)
    decode_ms = statistics.median(dec) * 1e3
    results[(f"serve_{arch}", cfg.dtype)] = dict(
        params_b=n_params / 1e9, prompt_tokens=sum(map(len, prompts)),
        padded_prompt_len=plen, waves=len(pre),
        prefill_ms_per_wave=[x * 1e3 for x in pre],
        prefill_tokens_per_s=prompt_tps,
        decode_ms_per_step=decode_ms, decode_steps=len(dec),
        decode_tokens_per_s=SERVE_SLOTS / statistics.median(dec),
        latency_s=[r.latency_s for r in reqs],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"{label}: prefill {[round(x * 1e3, 2) for x in pre]} ms a wave "
        f"({SERVE_SLOTS} x {plen} tokens: {prompt_tps:.0f} prompt "
        f"tokens/s over the waves), decode {decode_ms:.3f} ms a "
        f"step (median of {len(dec)}; "
        f"{SERVE_SLOTS / statistics.median(dec):.1f} tokens/s); request "
        f"latency {min(r.latency_s for r in reqs):.2f}-"
        f"{max(r.latency_s for r in reqs):.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return {k: counts[k] for k in ("flash_attn", "lru_scan")}


def serve_phase(torch, dev, check, results, main_launches):
    """The LM serving path on the card (phase 6): the flash-attention and
    LRU kernels against their plain versions, then `ServeEngine` over both
    full-width models with the planned launch counts, equal to a hand-rolled
    prefill + decode loop, the reduced models on the card against the CPU,
    and the times of prefill, decode and the two kernels. Returns each
    serving path's launch counts of the two kernels, by arch."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash as flash_k
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.lru_scan import ref as lru_ref
    from repro_torch.kernels.lru_scan.lru_scan import lru_scan_cuda
    from repro_torch.models import api, lm

    gen = torch.Generator(device=dev).manual_seed(6)

    # ---- (a) the kernels against their plain versions, white noise ------
    flash_cases = [
        # label, b, t, s, h, kh, hd, causal, window, softcap
        ("recurrentgemma prefill", 4, 1024, 1024, 16, 1, 256, True, 0, 0.0),
        ("tinyllama prefill (GQA g=8)", 4, 1024, 1024, 32, 4, 64, True, 0,
         0.0),
        ("window 128", 2, 512, 512, 8, 2, 128, True, 128, 0.0),
        ("softcap 30", 2, 256, 256, 8, 1, 64, True, 0, 30.0),
        ("ragged T=77", 2, 77, 77, 8, 1, 256, True, 0, 0.0),
        ("T != S non-causal", 2, 200, 333, 8, 2, 64, False, 0, 0.0),
        ("window, rows with no key", 1, 300, 200, 8, 1, 32, True, 50, 0.0),
        ("reduced-config head_dim 16", 2, 24, 24, 4, 1, 16, True, 16, 0.0),
    ]
    flash_shapes = {}
    for label, b, t, s, h, kh, hd, causal, window, softcap in flash_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, t, h, hd), (b, s, kh, hd),
                                     (b, s, kh, hd)))
            want = flash_ref.mha(q.float(), k.float(), v.float(),
                                 causal=causal, window=window,
                                 softcap=softcap)
            rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8
            # each route's tiles that fit at the prefill shapes, its
            # auto-picked tile elsewhere
            blocks = [bl for bl in flash_k.blocks(dtype)
                      if flash_k.smem_bytes(hd, *bl, dtype)
                      <= flash_k.SMEM_BUDGET] if t == 1024 else (
                flash_ops.auto_blocks(hd, dtype=dtype),)
            worst = 0.0
            for bq, bk in blocks:
                got = flash_k.flash_mha_cuda(q, k, v, causal=causal,
                                             window=window, softcap=softcap,
                                             block_q=bq, block_k=bk)
                torch.cuda.synchronize()
                ok, err = within(got, want, rtol)
                say(f"flash {label} {tuple(q.shape)}/{tuple(k.shape)} "
                    f"{str(dtype)[6:]} blocks ({bq}, {bk}): err {err:.3g} "
                    f"(atol 2e-5 + {rtol:.3g}|want|)")
                check(ok, f"flash {label} {dtype} ({bq}, {bk}): disagrees "
                      f"with its plain version")
                worst = max(worst, err)
            if t == 1024:
                flash_shapes[label] = (q, k, v, worst, causal)
            del q, k, v, want, got
    for dtype in (torch.float32, torch.bfloat16):
        shape = (4, 1024, 4096)
        a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=dev)
             ).to(dtype)
        bb = torch.randn(shape, generator=gen, device=dev).to(dtype)
        want = lru_ref.lru_scan_ref(a.float(), bb.float())
        rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8 + 2e-5
        ok, err = within(lru_scan_cuda(a, bb), want, rtol)
        ok2, err2 = within(lru_scan_cuda(a[0], bb[0]), want[0], rtol)
        say(f"lru_scan {shape} {str(dtype)[6:]}: err {err:.3g}, (T, C) "
            f"layout err {err2:.3g} (atol 2e-5 + {rtol:.3g}|want|)")
        check(ok and ok2, f"lru_scan {dtype}: disagrees with its plain "
              f"version")
        if dtype == torch.float32:
            lru_ms = time_ms(lambda: lru_scan_cuda(a, bb))
            lru_queued_ms = stream_ms(lambda: lru_scan_cuda(a, bb))
            lru_plain_ms = time_ms(lambda: lru_ref.lru_scan_ref(a, bb))
            b_ms, b_by = bound(3 * a.numel() * a.element_size(),
                               2.0 * a.numel())
            results[("lru_scan", "float32")] = dict(
                err=err, ms=lru_ms, queued_ms=lru_queued_ms,
                plain_ms=lru_plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=list(shape))
            say(f"lru_scan {shape} float32: {lru_ms:.4f} ms, queued "
                f"{lru_queued_ms:.4f} ms (plain {lru_plain_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}; no single PyTorch call computes "
                f"it)")
        del a, bb, want
    torch.cuda.empty_cache()

    # The flash kernel's times at both models' prefill shapes.
    for label, name in FLASH_TIMES:
        q, k, v, err, causal = flash_shapes[label]
        time_flash(torch, results, name, label, q, k, v, err, causal)
        del q, k, v
    flash_shapes.clear()
    torch.cuda.empty_cache()

    # ---- (b) serving at full width -------------------------------------
    path_launches = {}
    for arch in SERVE_ARCHS:
        cfg = registry.get_config(arch)
        kinds = lm.layer_kinds(cfg)
        n_attn = sum(kd != "rec" for kd in kinds)
        torch.cuda.reset_peak_memory_stats()
        model = api.build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        path_launches[arch] = serve_model(torch, dev, check, results, model,
                                          params, n_attn,
                                          len(kinds) - n_attn)
        if arch == SERVE_ARCHS[0]:
            main_launches.update(path_launches[arch])
        del model, params
        torch.cuda.empty_cache()

    # Reduced configs, fp32: the same model on the card (kernels) and on
    # the CPU (plain versions), at the fp32 parity test's 3e-4.
    for arch in ("tinyllama-1.1b", "recurrentgemma-9b", "gemma3-27b",
                 "olmo-1b"):
        cfg = dataclasses.replace(
            registry.reduced_config(registry.get_config(arch)),
            dtype="float32", param_dtype="float32")
        model = api.build(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 25)))
        logits = []
        for where in ("cpu", dev):
            if where != "cpu":
                model = api.build(cfg)
                params = params.to(dev)          # moves the module in place
            with torch.inference_mode():
                tk = toks.to(where)
                lp, cache = model.prefill(params, {"tokens": tk[:, :24]},
                                          max_len=32)
                ld, _ = model.decode_step(params, cache, tk[:, 24:], 24)
            logits.append((lp.float().cpu(), ld.float().cpu()))
        err = max(float((c - g).abs().max()) for c, g in zip(*logits))
        scale = max(float(c.abs().max()) for c in logits[0])
        say(f"reduced {arch} fp32: card vs CPU logits err {err:.3g} (atol "
            f"3e-4 + 3e-4|want|, |logits| <= {scale:.3g})")
        check(all(bool(((g - c).abs() <= 3e-4 + 3e-4 * c.abs()).all())
                  for c, g in zip(*logits)),
              f"reduced {arch}: the card disagrees with the CPU")
        del model, params
    torch.cuda.empty_cache()
    return path_launches


def random_head(torch, gen, d, vp, tied, dtype):
    """A (D, Vp) LM head from `gen`: `embed.T` (contiguous along D) when
    tied."""
    w = (torch.randn(vp, d, generator=gen, device=gen.device) * 0.02
         ).to(dtype)
    return w.T if tied else w.T.contiguous()


def train_model(torch, dev, check, results, cfg, steps, gen):
    """`train.loop.fit` over `cfg` at TRAIN_BATCH x TRAIN_SEQ in bf16 for
    `steps` steps (remat="full") with the planned launches, a finite loss
    and moved parameters, a profiled step, and the xent kernel at its
    training shape against its plain version, timed (its inputs and head
    from `gen`). Returns the run's flash, LRU and xent launches."""
    import math

    import torch.nn.functional as F

    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.xent import ops as xent_ops
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent import xent as xent_k
    from repro_torch.models import api, lm
    from repro_torch.train import loop, optim

    arch = cfg.name
    label = f"train {arch}"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kinds = lm.layer_kinds(cfg)
    period = len(cfg.pattern)
    recomputed = kinds[:cfg.n_repeats * period]    # remat="full"
    attn = [k not in ("rec", "ssd") for k in kinds]
    plan = {"flash_attn": sum(attn) + sum(attn[:len(recomputed)]),
            "lru_scan": 2 * kinds.count("rec") + recomputed.count("rec"),
            "xent": 1}
    torch.cuda.reset_peak_memory_stats()
    model = api.build(cfg)
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=5,
                              total_steps=steps)
    data = synthetic.iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                              device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    params, opt_state, hist = loop.fit(model, data, steps=steps,
                                       opt_cfg=opt_cfg, remat="full",
                                       log_every=0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = {k: v * steps for k, v in plan.items() if v}
    say(f"{label}: {cfg.param_count() / 1e9:.3f} B parameters, "
        f"{len(kinds)} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"remat full, {steps} steps; launches {counts} (planned "
        f"{want}: {plan} a step)")
    check(counts == want, f"{label}: launched {counts}, planned {want}")
    launches = {k: counts.get(k, 0)
                for k in ("flash_attn", "lru_scan", "xent")}
    losses = [hh["loss"] for hh in hist]
    finite = all(math.isfinite(hh["loss"])
                 and math.isfinite(hh["grad_norm"]) for hh in hist)
    init = model.init(torch.Generator(device=dev).manual_seed(0))
    moved = all(not torch.equal(p0, p1) for p0, p1 in
                zip(init.parameters(), params.parameters()))
    del init
    say(f"{label}: loss per step {[round(x, 4) for x in losses]}, grad "
        f"norm {[round(hh['grad_norm'], 3) for hh in hist]}; finite "
        f"{finite}; every parameter moved {moved}")
    check(finite, f"{label}: a non-finite loss or gradient norm")
    check(len(set(losses)) > 1, f"{label}: the loss did not move")
    check(moved, f"{label}: a parameter did not move")
    step_s = statistics.median(hh["time_s"] for hh in hist[1:])
    mfu = 6 * cfg.param_count() * tokens / step_s / BF16_FLOPS_PER_S
    peak = torch.cuda.max_memory_allocated() / 1e9

    # one more step, profiled in two halves: loss + gradients, then the
    # optimizer update (the step `fit` runs, split)
    batch = next(data)
    holder = {}

    def fwd_bwd():
        loss = model.loss(params, batch, remat="full")
        holder["grads"] = torch.autograd.grad(
            loss, list(params.parameters()))

    def update():
        optim.apply_updates(opt_cfg, params, opt_state,
                            holder.pop("grads"))

    prof = {"loss_and_grads": device_breakdown(fwd_bwd),
            "optimizer": device_breakdown(update)}
    results[(f"train_{arch}", cfg.dtype)] = dict(
        layers=len(kinds), params_b=cfg.param_count() / 1e9,
        steps=steps, losses=losses, step_ms=step_s * 1e3,
        step_ms_each=[hh["time_s"] * 1e3 for hh in hist],
        tokens_per_s=tokens / step_s, mfu=mfu, peak_gb=peak,
        launches_per_step=plan, launches=counts, profile=prof)
    say(f"{label}: step {step_s * 1e3:.1f} ms (median after the first; "
        f"each {[round(hh['time_s'] * 1e3, 1) for hh in hist]}), "
        f"{tokens / step_s:.0f} tokens/s, mfu {mfu:.4f} (6 x "
        f"{cfg.param_count() / 1e9:.3f} B x {tokens} tokens a step over "
        f"989 TFLOP/s), peak memory {peak:.1f} GB")
    for part, br in prof.items():
        if br is None:
            say(f"{label} {part}: the profiler saw no device kernel "
                f"(device breakdown not measured)")
            continue
        say(f"{label} {part} under torch.profiler: host window "
            f"{br['wall_ms']:.2f} ms, device busy {br['busy_ms']:.2f} ms "
            f"(idle share {br['idle_share']:.3f}), {br['kernels']} "
            f"kernels (read in {br['read_s']:.1f} s); by kind (ms) "
            + ", ".join(f"{k} {v:.2f}"
                        for k, v in br["by_category_ms"].items()))
    del model, params, opt_state, data, batch, holder
    torch.cuda.empty_cache()

    # the xent kernel at this training shape (bf16, as the model runs)
    n, d, vp = TRAIN_BATCH * (TRAIN_SEQ - 1), cfg.d_model, cfg.padded_vocab
    h = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = random_head(torch, gen, d, vp, cfg.tie_embeddings, torch.bfloat16)
    t = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev)
    nll, lse = xent_ops.xent_rows(h, w, t, vocab=cfg.vocab_size)
    want_nll, want_lse = xent_ref.xent_rows(h.float(), w.float(), t,
                                            None, cfg.vocab_size)
    err = float((nll - want_nll).abs().max())
    sum_err = abs(float(nll.sum()) - float(want_nll.sum()))
    ok = all(bool(((g - wt).abs() <= 1e-4 + 1e-4 * wt.abs()).all())
             for g, wt in ((nll, want_nll), (lse, want_lse)))
    ok &= sum_err <= 1e-4 * abs(float(want_nll.sum()))
    say(f"xent {arch} training shape N={n} "
        f"({xent_k.splits(n, vp, sms, torch.bfloat16)[0]}"
        f" vocab splits): nll err {err:.3g}, lse err "
        f"{float((lse - want_lse).abs().max()):.3g} (per row 1e-4 + "
        f"1e-4|want|), sum err {sum_err:.3g} (rtol 1e-4)")
    check(ok, f"xent {arch} training shape: disagrees with its plain "
          f"version")
    del nll, lse, want_nll, want_lse
    reps = 5
    # each call's time: a call is slower where the row blocks sharing a
    # head tile drift apart and re-read it from device memory
    each = times_ms(lambda: xent_ops.xent_rows(h, w, t,
                                               vocab=cfg.vocab_size), reps)
    ms = statistics.median(each)
    queued_ms = stream_ms(lambda: xent_ops.xent_rows(
        h, w, t, vocab=cfg.vocab_size), reps)
    plain_ms = time_ms(lambda: xent_ref.xent_rows(
        h, w, t, None, cfg.vocab_size), reps)
    library_ms = time_ms(lambda: F.cross_entropy(
        h @ w, t.long(), reduction="none"), reps)
    flops = 2.0 * n * d * vp           # the logits' products
    nbytes = (n * d + d * vp) * 2 + n * (4 + 4 + 4)
    # bf16 inputs: their products are exact in fp32, so the card's
    # rate for this function is the bf16 tensor cores' (fp32
    # accumulation), the route bf16 takes; the fp32 cores' bound, the
    # fp32 route's at this shape, is kept beside it
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    fp32_ms, _ = bound(nbytes, flops)
    results[(f"xent_{arch}", "bfloat16")] = dict(
        err=err, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
        bound_fp32_cores_ms=fp32_ms,
        shape=[n, d, vp], tied=cfg.tie_embeddings,
        tflops=flops / ms * 1e-9, ms_each=each)
    say(f"xent {arch} training shape N={n} D={d} Vp={vp} bf16"
        f"{' (embed.T)' if cfg.tie_embeddings else ''}: {ms:.3f} ms = "
        f"{flops / ms * 1e-9:.2f} TFLOP/s (calls "
        f"{[round(x, 3) for x in each]} ms; {reps} queued back to back "
        f"{queued_ms:.3f} ms a call; err {err:.3g}; plain "
        f"{plain_ms:.3f} ms; library pair h @ head + F.cross_entropy, "
        f"two calls, {library_ms:.3f} ms; bound {b_ms:.3f} ms by {b_by} "
        f"at 989 TFLOP/s bf16; on the fp32 cores' 67 TFLOP/s "
        f"{fp32_ms:.3f} ms)")
    del h, w, t
    torch.cuda.empty_cache()
    return launches


def reduced_train_step(torch, dev, check, arch):
    """One AdamW step of `arch`'s reduced config in fp32 on the card
    (kernels) against the same step on the CPU (plain versions): loss,
    grad norm and updated parameters within 1e-4."""
    import copy
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.train import loop, optim

    cfg = dataclasses.replace(
        registry.reduced_config(registry.get_config(arch)),
        dtype="float32", param_dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic.lm_batch(cfg, 0, 0, 2, 33).items()}
    params = api.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    out = []
    for where in ("cpu", dev):
        model = api.build(cfg, device=where)
        p = copy.deepcopy(params).to(where)
        step = loop.make_train_step(model, optim.OptConfig(lr=1e-3),
                                    remat="full")
        p, _, m = step(p, optim.init_opt_state(p),
                       {k: v.to(where) for k, v in batch.items()})
        out.append(({k: float(v) for k, v in m.items()},
                    [x.detach().cpu() for x in p.parameters()]))
    (mc, pc), (mg, pg) = out
    err_m = max(abs(mg[k] - mc[k]) / abs(mc[k])
                for k in ("loss", "grad_norm"))
    err_p = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    say(f"reduced {arch} fp32 train step: card vs CPU loss/grad-norm "
        f"relative err {err_m:.3g}, updated params err {err_p:.3g} "
        f"(limit 1e-4)")
    check(err_m <= 1e-4 and err_p <= 1e-4,
          f"reduced {arch} train step: the card disagrees with the CPU")


def train_phase(torch, dev, check, results):
    """The LM training path on the card (phase 7): the cross-entropy
    kernel against its plain version, the gradients of the three kernels'
    autograd Functions against autograd of their plain versions, AdamW
    steps of tinyllama-1.1b and recurrentgemma-9b at full width through
    `train.loop.fit` with the planned launches, a reduced fp32 step on the
    card against the CPU, and the times of a step (with a profiler split)
    and of the xent kernel at each training shape. Returns each training
    path's launch counts of the three kernels, by arch."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.lru_scan import ref as lru_ref
    from repro_torch.kernels.lru_scan.lru_scan import lru_scan_cuda
    from repro_torch.kernels.xent import ops as xent_ops
    from repro_torch.kernels.xent import ref as xent_ref
    from repro_torch.kernels.xent import xent as xent_k

    gen = torch.Generator(device=dev).manual_seed(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- (a) the xent kernel against its plain version ------------------
    # label, n, d, vp, vocab, softcap, valid_frac, tied
    xent_cases = [("tinyllama", n, 2048, 32000, 32000, 0.0, None, False)
                  for n in (1024, 1000)]
    xent_cases += [("recurrentgemma", n, 4096, 256000, 256000, 0.0, None,
                    True) for n in (1024, 1000)]
    xent_cases.append(("granite padded vocab, softcap 30, valid mask", 1000,
                       1536, 49280, 49155, 30.0, 0.5, False))
    for label, n, d, vp, vocab, softcap, vfrac, tied in xent_cases:
        for dtype in (torch.float32, torch.bfloat16):
            h = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            w = random_head(torch, gen, d, vp, tied, dtype)
            t = torch.randint(0, vocab, (n,), generator=gen, device=dev)
            v = (None if vfrac is None else
                 (torch.rand(n, generator=gen, device=dev) < vfrac).float())
            nll, lse = xent_k.xent_cuda(h, w, t, v, vocab=vocab,
                                        softcap=softcap)
            want_nll, want_lse = xent_ref.xent_rows(h.float(), w.float(), t,
                                                    v, vocab, softcap)
            torch.cuda.synchronize()
            ok = all(bool(((g - wt).abs() <= 1e-4 + 1e-4 * wt.abs()).all())
                     for g, wt in ((nll, want_nll), (lse, want_lse)))
            sum_err = abs(float(nll.sum()) - float(want_nll.sum()))
            ok &= sum_err <= 1e-4 * abs(float(want_nll.sum()))
            if v is not None:
                ok &= float(nll[v == 0].abs().max()) == 0.0
            err = float((nll - want_nll).abs().max())
            say(f"xent {label} N={n} D={d} Vp={vp} {str(dtype)[6:]}"
                f"{' (embed.T)' if tied else ''}: nll err {err:.3g}, lse err "
                f"{float((lse - want_lse).abs().max()):.3g} (per row 1e-4 + "
                f"1e-4|want|), sum err {sum_err:.3g} (rtol 1e-4)"
                + ("; masked rows exactly 0" if v is not None else ""))
            check(ok, f"xent {label} N={n} {dtype}: disagrees with its "
                  f"plain version")
            del h, w, t, v, nll, lse, want_nll, want_lse
    torch.cuda.empty_cache()
    # the flash kernel at the training path's own shapes (bf16, the blocks
    # `flash_mha` picks), at phase 6's limits
    for label, qs, ks, window in (
            ("tinyllama training (GQA g=8)", (TRAIN_BATCH, TRAIN_SEQ, 32, 64),
             (TRAIN_BATCH, TRAIN_SEQ, 4, 64), 0),
            ("recurrentgemma training (MQA, window 2048)",
             (TRAIN_BATCH, TRAIN_SEQ, 16, 256),
             (TRAIN_BATCH, TRAIN_SEQ, 1, 256), 2048)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in (qs, ks, ks))
        got = flash_ops.flash_mha(q, k, v, window=window)
        want = flash_ref.mha(q.float(), k.float(), v.float(), window=window)
        d = (got.float() - want).abs()
        say(f"flash {label} {qs}/{ks} bf16 blocks "
            f"{flash_ops.auto_blocks(qs[3], dtype=torch.bfloat16)}: err "
            f"{float(d.max()):.3g} (atol "
            f"2e-5 + {2.0 ** -8:.3g}|want|)")
        check(bool((d <= 2e-5 + 2.0 ** -8 * want.abs()).all()),
              f"flash {label}: disagrees with its plain version")
        del q, k, v, got, want, d
    torch.cuda.empty_cache()

    # ---- (b) the Functions' gradients against autograd of the plain -----
    def grads_close(label, got, want, rtol):
        """Each gradient within rtol of its largest magnitude."""
        errs = [float((g.float() - wt.float()).abs().max())
                / max(float(wt.float().abs().max()), 1e-30)
                for g, wt in zip(got, want)]
        say(f"grad {label}: relative errs "
            + ", ".join(f"{e:.3g}" for e in errs) + f" (limit {rtol:g})")
        check(max(errs) <= rtol, f"grad {label}: disagrees with autograd "
              f"of its plain version")

    for tied in (False, True):
        h = torch.randn(700, 256, generator=gen, device=dev)
        w = random_head(torch, gen, 256, 32000, tied, torch.float32)
        t = torch.randint(0, 31900, (700,), generator=gen, device=dev)
        cot = torch.randn(700, generator=gen, device=dev)
        xs = [x.detach().requires_grad_() for x in (h, w)]
        got = torch.autograd.grad((xent_ops.xent(
            *xs, t, vocab=31900, softcap=30.0) * cot).sum(), xs)
        ys = [x.detach().requires_grad_() for x in (h, w)]
        want = torch.autograd.grad((xent_ref.xent_rows(
            *ys, t, None, 31900, 30.0)[0] * cot).sum(), ys)
        grads_close(f"XentFn (700, 256) x (256, 32000){' embed.T' if tied else ''}"
                    f" fp32, vocab 31900, softcap 30", got, want, 2e-5)
        # bf16, the training path's dtype, with logits of order 10, against
        # autograd of the plain version in fp32 on the same values: two
        # bf16 roundings (the gradient operand and the output)
        h, w = h.bfloat16(), (w.float() * 30.0).bfloat16()
        xs = [x.detach().requires_grad_() for x in (h, w)]
        got = torch.autograd.grad((xent_ops.xent(
            *xs, t, vocab=31900, softcap=30.0) * cot).sum(), xs)
        ys = [x.detach().float().requires_grad_() for x in (h, w)]
        want = torch.autograd.grad((xent_ref.xent_rows(
            *ys, t, None, 31900, 30.0)[0] * cot).sum(), ys)
        grads_close(f"XentFn (700, 256) x (256, 32000){' embed.T' if tied else ''}"
                    f" bf16, vocab 31900, softcap 30", got, want, 2.0 ** -7)
    a = 0.3 + 0.69 * torch.rand(2, 256, 512, generator=gen, device=dev)
    b = torch.randn(2, 256, 512, generator=gen, device=dev)
    cot = torch.randn(2, 256, 512, generator=gen, device=dev)
    xs = [x.detach().requires_grad_() for x in (a, b)]
    got = torch.autograd.grad((lru_ops.lru_scan(*xs) * cot).sum(), xs)
    ys = [x.detach().requires_grad_() for x in (a, b)]
    want = torch.autograd.grad((lru_ref.lru_scan_ref(*ys) * cot).sum(), ys)
    grads_close("LruScanFn (2, 256, 512) fp32", got, want, 2e-5)
    for dtype in (torch.float32, torch.bfloat16):
        shape = (TRAIN_BATCH, TRAIN_SEQ, 4096)
        a = (0.3 + 0.69 * torch.rand(shape, generator=gen, device=dev)
             ).to(dtype)
        b = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got = lru_scan_cuda(a, b, reverse=True)
        want = lru_ref.lru_scan_ref(a.float().flip(1), b.float().flip(1)
                                    ).flip(1)
        rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8 + 2e-5
        d = (got.float() - want).abs()
        say(f"lru_scan reverse {shape} {str(dtype)[6:]}: err "
            f"{float(d.max()):.3g} (atol 2e-5 + {rtol:.3g}|want|)")
        check(bool((d <= 2e-5 + rtol * want.abs()).all()),
              f"lru_scan reverse {dtype}: disagrees with the flipped plain "
              f"version")
        if dtype == torch.float32:
            rev_ms = time_ms(lambda: lru_scan_cuda(a, b, reverse=True))
            rev_queued_ms = stream_ms(lambda: lru_scan_cuda(a, b,
                                                            reverse=True))
            b_ms, _ = bound(3 * a.numel() * 4, 2.0 * a.numel())
            results[("lru_scan_reverse", "float32")] = dict(
                err=float(d.max()), ms=rev_ms, queued_ms=rev_queued_ms,
                bound_ms=b_ms, shape=list(shape))
            say(f"lru_scan reverse {shape} float32: {rev_ms:.4f} ms, queued "
                f"{rev_queued_ms:.4f} ms (bound {b_ms:.4f} ms by bytes)")
        del a, b, got, want, d
    for label, shp in (("recurrentgemma MQA hd 256", ((2, 256, 16, 256),
                                                        (2, 256, 1, 256))),
                       ("tinyllama GQA g=8", ((2, 256, 32, 64),
                                              (2, 256, 4, 64)))):
        q = torch.randn(shp[0], generator=gen, device=dev)
        k, v = (torch.randn(shp[1], generator=gen, device=dev)
                for _ in range(2))
        cot = torch.randn(shp[0], generator=gen, device=dev)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad((flash_ops.flash_mha(*xs) * cot).sum(), xs)
        ys = [x.detach().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad((flash_ref.mha(*ys) * cot).sum(), ys)
        grads_close(f"FlashFn {label} fp32", got, want, 2e-5)
    torch.cuda.empty_cache()

    # ---- (c) training at full width through fit --------------------------
    path_launches = {}
    for arch, layers, steps in TRAIN_RUNS:
        full = registry.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers) if layers else full
        label = f"train {arch}"
        if layers:
            say(f"{label}: depth cut to {layers} layers (one "
                f"{cfg.pattern} period) at full width: all "
                f"{full.n_layers} layers ({full.param_count() / 1e9:.2f} B "
                f"parameters) would need "
                f"{full.param_count() * 16 / 1e9:.0f} GB for bf16 weights "
                f"and gradients and fp32 m, v and master, more than the "
                f"card's 80 GB")
        path_launches[arch] = train_model(torch, dev, check, results, cfg,
                                          steps, gen)
        if arch == TRAIN_RUNS[0][0]:
            remat_steps(torch, dev, check, results, cfg)

    # ---- (d) reduced configs, fp32: one step on the card vs the CPU ------
    for arch in ("tinyllama-1.1b", "recurrentgemma-9b"):
        reduced_train_step(torch, dev, check, arch)
    torch.cuda.empty_cache()
    return path_launches


def forecast_phase(torch, dev, check, results):
    """Forecast serving on the card (phase 8): the slot-guard kernel
    against its plain version (a lane-sized batch, clean and poisoned,
    fp32 and bf16, and each served lane's own batch), timed against its
    bound; `ForecastEngine` over the main path's domain, 4 slots, with a
    dycore fp32 lane and a bf16 lane (FORECAST_REQUESTS requests each,
    steps from a seed), an `op="hdiff"` lane and a pinned k=2 lane with
    ragged steps: every result bit-equal to its solo `run`, each lane
    round's launches as planned (one step kernel and one guard), no
    fallback, scrub or divergence; a `poison_nan` fault quarantining one
    slot while the others stay bit-equal; an injected `compile_fail` on
    `native` reaching the reference plan; a mid-drain checkpoint and
    restore finishing bit-equal to the uninterrupted drain; reduced
    tinyllama `fit` on the card with `ckpt_every=2`, resumed, bit-equal
    to an uninterrupted run. Prints the engine round beside `plan.step` of
    the same ensemble-4 plan, and the submit, admit and retire times.
    Returns the forecast drain's launch counts."""
    import shutil

    import numpy as np

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_guard import ref as guard_ref
    from repro_torch.kernels.slot_guard.slot_guard import slot_guard_cuda
    from repro_torch.models import api
    from repro_torch.serve.forecast import ForecastEngine, ForecastRequest
    from repro_torch.testing.faults import FaultInjector, FaultSpec
    from repro_torch.train import loop, optim
    from repro_torch.weather import dycore, fields
    from repro_torch.weather import program as wprog

    limit = 1e6
    slots = ENSEMBLE
    gen = torch.Generator(device=dev).manual_seed(24)
    rng = np.random.default_rng(24)

    def guard_equal(leaves, label):
        """The kernel's (ok, fp) against the plain version's on the same
        leaves, bit for bit; these launches are not the path's. The
        measured discrepancy, the largest |kernel - plain| over the slots'
        ok bits and uint32 digests (0 when bit-equal), is folded into its
        dtype's `slot_guard` row as `err`."""
        n = _build.LAUNCHES["slot_guard"]
        ok, fp = slot_guard_cuda(leaves, limit)
        _build.LAUNCHES["slot_guard"] = n
        want_ok, want_fp = guard_ref.slot_guard(leaves, limit)
        got = [int(v) for v in ok.tolist() + fp.tolist()]
        want = [int(v) for v in want_ok.tolist() + want_fp.tolist()]
        err = float(max(abs(a - b) for a, b in zip(got, want)))
        dtype = fields.dtype_name(leaves[0].dtype)
        guard_err[dtype] = max(guard_err.get(dtype, 0.0), err)
        if ("slot_guard", dtype) in results:
            results[("slot_guard", dtype)]["err"] = guard_err[dtype]
        check(err == 0.0, f"slot guard {label}: the kernel differs from "
              f"its plain version by {err} ({ok.tolist()} {fp.tolist()} "
              f"against {want_ok.tolist()} {want_fp.tolist()})")
        return ok.tolist()

    guard_err = {}

    # ---- (a) the guard kernel on a lane-sized batch ---------------------
    for dtype in ("float32", "bfloat16"):
        st = fields.initial_state(gen, GRID, slots, dtype=dtype, device=dev)
        leaves = wprog.state_leaves(st)
        oks = guard_equal(leaves, f"{dtype} clean")
        check(oks == [True] * slots, f"slot guard {dtype}: a clean lane "
              f"failed its guard: {oks}")
        st.fields["u"][1, 3, 5, 7] = float("nan")
        st.tens["t"][2, 0, 0, 0] = 2 * limit
        st.stage_tens["pp"][3, 1, 2, 3] = -0.0
        oks = guard_equal(leaves, f"{dtype} poisoned")
        check(oks == [True, False, False, True], f"slot guard {dtype}: "
              f"poisoned lane gave {oks}, expected [T, F, F, T]")
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        kernel = lambda: slot_guard_cuda(leaves, limit)
        n = _build.LAUNCHES["slot_guard"]
        ms, queued = time_ms(kernel), stream_ms(kernel)
        _build.LAUNCHES["slot_guard"] = n
        plain = time_ms(lambda: guard_ref.slot_guard(leaves, limit), reps=5)
        bound_ms, bound_by = bound(nbytes, 0.0)
        results[("slot_guard", dtype)] = dict(
            err=guard_err[dtype], ms=ms, queued_ms=queued, plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            lane_bytes=nbytes)
        say(f"slot guard {dtype}: {len(leaves)} leaves x {slots} slots, "
            f"{nbytes / 1e6:.1f} MB; kernel {ms:.4f} ms by call, "
            f"{queued:.4f} ms queued (bound {bound_ms:.4f} ms, bytes), "
            f"plain {plain:.3f} ms; ok and digests bit-equal to the plain "
            f"version, clean and poisoned")
        del st, leaves
    torch.cuda.empty_cache()

    # ---- (b) the served mix ----------------------------------------------
    class Recorded(ForecastEngine):
        """The engine, with each lane round's launches and host time, and
        each admission, retirement and submission's host time, recorded;
        the guard kernel is held against its plain version on each lane's
        batch after its first round."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log, self.admit_s, self.retire_s = [], [], []
            self.submit_s, self.checked = [], set()

        def submit(self, request):
            t0 = time.perf_counter()
            rid = super().submit(request)
            torch.cuda.synchronize()
            self.submit_s.append(time.perf_counter() - t0)
            return rid

        def _admit(self):
            n = self._stats["admitted"]
            t0 = time.perf_counter()
            super()._admit()
            torch.cuda.synchronize()
            if self._stats["admitted"] > n:
                self.admit_s.append(((time.perf_counter() - t0),
                                     self._stats["admitted"] - n))

        def _retire(self, lane, i):
            t0 = time.perf_counter()
            super()._retire(lane, i)
            self.retire_s.append((lane.key.dtype, time.perf_counter() - t0))

        def _round(self, lane):
            plan = self._plan_for(lane.key)
            kk = min(min(s.remaining, plan.k_steps)
                     for s in lane.slots if s is not None)
            before = dict(_build.LAUNCHES)
            done = self._stats["completed"]
            t0 = time.perf_counter()
            super()._round(lane)
            dt = time.perf_counter() - t0
            self.log.append(dict(
                key=lane.key, kk=kk, s=dt,
                retired=self._stats["completed"] - done,
                launches={k: v - before[k]
                          for k, v in _build.LAUNCHES.items()
                          if v != before[k]}))
            if lane.key not in self.checked and any(lane.slots):
                self.checked.add(lane.key)
                guard_equal(wprog.state_leaves(lane.batch),
                            f"on the {self._lane_name(lane.key)} lane")

        @staticmethod
        def _lane_name(key):
            kind = key.op if key.variant != "kstep" else \
                f"{key.op} k={key.k_steps}"
            return f"{kind} {key.dtype}"

    def request_state(dtype, seed):
        """A request's initial state, made on the card and handed over in
        host memory, as a client would submit it."""
        g = torch.Generator(device=dev).manual_seed(seed)
        st = fields.initial_state(g, GRID, 1, dtype=dtype, device=dev)
        return wprog.map_state(st, lambda t: t.cpu())

    solo_plans = {}

    def solo(prog, state, steps):
        plan = solo_plans.get(prog)
        if plan is None:
            plan = solo_plans.setdefault(prog, compile_plan(prog))
        out = plan.run(wprog.map_state(state, lambda t: t.to(dev)), steps)
        return wprog.map_state(out, lambda t: t.cpu())

    def compile_plan(prog):
        return wprog.compile(prog, device=dev)

    def equal_states(a, b):
        la, lb = wprog.state_leaves(a), wprog.state_leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(x, y) for x, y in zip(la, lb))

    programs = {
        "dycore float32": wprog.StencilProgram(grid_shape=GRID),
        "dycore bfloat16": wprog.StencilProgram(grid_shape=GRID,
                                                dtype="bfloat16"),
        "hdiff float32": wprog.StencilProgram(grid_shape=GRID, op="hdiff"),
        "dycore k=2 float32": wprog.StencilProgram(
            grid_shape=GRID, variant="kstep", k_steps=2)}
    mix = []
    for name in ("dycore float32", "dycore bfloat16"):
        mix += [(name, int(s)) for s in rng.integers(
            FORECAST_STEPS[0], FORECAST_STEPS[1] + 1, FORECAST_REQUESTS)]
    mix += [("hdiff float32", int(s)) for s in
            rng.integers(FORECAST_STEPS[0], FORECAST_STEPS[1] + 1, slots)]
    mix += [("dycore k=2 float32", s) for s in KSTEP_STEPS]
    states = [request_state(programs[name].dtype, 100 + i)
              for i, (name, _) in enumerate(mix)]
    eng = Recorded(slots=slots, device=dev)
    _build.reset_launches()
    rids = [eng.submit(ForecastRequest(program=programs[name], state=st_,
                                       steps=steps))
            for (name, steps), st_ in zip(mix, states)]
    t0 = time.perf_counter()
    res = eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    stats = eng.stats()
    steps_of = {n: [s for m, s in mix if m == n] for n in programs}
    shown = ("admitted", "completed", "rolled_back_slot_rounds",
             "quarantined", "scrubbed_idle_slots", "fingerprint_divergence",
             "fallback_compiles", "plan_fallbacks", "round_retries",
             "occupancy")
    say(f"forecast mix: {len(mix)} requests (steps by lane {steps_of}) on "
        f"{slots} slots, {stats['rounds']} lane rounds in {drain_s:.3f} s; "
        f"launches {({k: v for k, v in launches.items() if v})}; stats "
        f"{({k: stats[k] for k in shown})}")
    bad = [rid for rid in rids if res[rid].status != "ok"]
    check(not bad, f"forecast mix: requests {bad} did not finish ok")
    unequal = [rid for rid, (name, steps), st_ in zip(rids, mix, states)
               if not equal_states(res[rid].state,
                                   solo(programs[name], st_, steps))]
    say(f"forecast mix: {len(rids) - len(unequal)} of {len(rids)} results "
        f"bit-equal to their solo run(state, steps) at ensemble 1")
    check(not unequal, f"forecast mix: results {unequal} differ from "
          f"their solo runs")
    want_round = {"dycore": "dycore_fused", "hdiff": "hdiff"}
    wrong = []
    for e in eng.log:
        kern = ("dycore_kstep" if e["key"].variant == "kstep"
                and e["kk"] == 2 else want_round[e["key"].op])
        if e["launches"] != {kern: 1, "slot_guard": 1}:
            wrong.append((Recorded._lane_name(e["key"]), e["kk"],
                          e["launches"]))
    check(not wrong, f"forecast mix: lane rounds launched other than one "
          f"step kernel and one guard: {wrong[:4]}")
    check(launches["slot_guard"] == stats["rounds"],
          f"forecast mix: {launches['slot_guard']} guard launches for "
          f"{stats['rounds']} rounds")
    for key in ("fallback_compiles", "scrubbed_idle_slots",
                "fingerprint_divergence", "quarantined", "round_retries"):
        check(stats[key] == 0, f"forecast mix: stats {key} = {stats[key]}")
    check(stats["plan_fallbacks"] == {}, f"forecast mix: fallbacks "
          f"{stats['plan_fallbacks']}")
    check(stats["rolled_back_slot_rounds"] > 0
          and any(e["kk"] == 1 and e["key"].variant == "kstep"
                  for e in eng.log),
          "forecast mix: the k=2 lane ran no tail round or no rollback")
    unstacked = [Recorded._lane_name(k) for k, lane in eng._lanes.items()
                 if k.op == "dycore" and not all(
                     dycore._stacked_base(list(getattr(lane.batch, p)
                                               .values())) is not None
                     for p in ("fields", "tens", "stage_tens"))]
    check(not unstacked, f"forecast mix: lanes {unstacked} lost the "
          f"field-stacked layout")
    forecast_launches = {k: launches[k] for k in
                         ("dycore_fused", "dycore_kstep", "hdiff",
                          "slot_guard")}

    retire = {dt: [t * 1e3 for d_, t in eng.retire_s if d_ == dt]
              for dt in ("float32", "bfloat16")}
    admit = statistics.median(t / n for t, n in eng.admit_s) * 1e3
    submit = statistics.median(eng.submit_s) * 1e3
    slot_mb = 13 * GRID[0] * GRID[1] * GRID[2] * 4 / 1e6
    results[("forecast_host", "float32")] = dict(
        retire_ms={dt: statistics.median(v) for dt, v in retire.items()},
        retire_ms_each=retire, retire_share=sum(map(sum, retire.values()))
        / 1e3 / drain_s, admit_ms_per_request=admit, submit_ms=submit,
        drain_s=drain_s, rounds=stats["rounds"], requests=len(mix))
    say(f"forecast host: retire {statistics.median(retire['float32']):.3f}"
        f" ms fp32, {statistics.median(retire['bfloat16']):.3f} ms bf16 "
        f"(medians; one slot read back to host memory: {slot_mb:.0f} MB "
        f"fp32, {slot_mb / 2:.0f} MB bf16; the retirements took "
        f"{results[('forecast_host', 'float32')]['retire_share']:.3f} of "
        f"the drain), admit {admit:.3f} ms a request, submit {submit:.3f} "
        f"ms (pinned staging and the copy to the card)")
    del eng, res
    torch.cuda.empty_cache()

    # ---- (b2) steady rounds against plan.step of the same plan -----------
    # 4 requests of STEADY_STEPS steps on one lane: the rounds after the
    # first, before any retirement, on the host clock, then PROFILED_ROUNDS
    # more under the profiler for the device's share of a round
    for name in ("dycore float32", "dycore bfloat16"):
        prog = programs[name]
        eng = Recorded(slots=slots, device=dev)
        for i in range(slots):
            eng.submit(ForecastRequest(
                program=prog, state=request_state(prog.dtype, 200 + i),
                steps=STEADY_STEPS))
        for _ in range(STEADY_ROUNDS + 1):
            eng.pump()
        rounds = [e["s"] * 1e3 for e in eng.log[1:]]
        key = wprog.plan_cache_key(prog, ensemble=slots)
        lane = eng._lanes[key]
        busy = device_ms(lambda: eng._round(lane), n=PROFILED_ROUNDS)
        plan = eng._plans[key]
        batch = lane.batch
        step_ms = time_ms(lambda: plan.step(batch))
        step_q = stream_ms(lambda: plan.step(batch))
        guard = results[("slot_guard", prog.dtype)]
        rnd = statistics.median(rounds)
        results[("forecast_round", prog.dtype)] = dict(
            round_ms=rnd, rounds=len(rounds), round_ms_each=rounds,
            step_ms=step_ms, step_queued_ms=step_q, guard_ms=guard["ms"],
            host_ms=rnd - step_ms - guard["ms"], device_ms=busy,
            idle_share=None if busy is None else 1 - busy / rnd)
        say(f"forecast {name}: engine round {rnd:.4f} ms (median of "
            f"{len(rounds)} steady rounds; range {min(rounds):.4f}-"
            f"{max(rounds):.4f}) against plan.step {step_ms:.4f} ms by "
            f"call, {step_q:.4f} ms queued, and the guard {guard['ms']:.4f} "
            f"ms by call: {rnd - step_ms - guard['ms']:.4f} ms of host "
            f"bookkeeping; the device busy "
            + ("not measured" if busy is None else
               f"{busy:.4f} ms of a round under the profiler (idle share "
               f"{1 - busy / rnd:.3f})"))
        eng.drain()
        del eng, lane, batch
    torch.cuda.empty_cache()

    # ---- (c) a poisoned slot is quarantined, the others stay exact ------
    prog = programs["dycore float32"]
    work = [(request_state("float32", 300 + i), 4) for i in range(slots)]
    inj = FaultInjector([FaultSpec(kind="poison_nan", round=1)], seed=5)
    eng = ForecastEngine(slots=slots, device=dev, fault_injector=inj)
    rids = [eng.submit(ForecastRequest(program=prog, state=s, steps=n))
            for s, n in work]
    res = eng.drain()
    failed = [rid for rid in rids if res[rid].status == "failed"]
    healthy = [rid for rid, (s, n) in zip(rids, work)
               if res[rid].status == "ok"
               and equal_states(res[rid].state, solo(prog, s, n))]
    diag = res[failed[0]].diagnosis if failed else {}
    say(f"forecast poison_nan at round 1: failed {failed} "
        f"({diag.get('reason')}, leaves {sorted(diag.get('bad_leaves', {}))}"
        f"), {len(healthy)} others bit-equal to solo; quarantined "
        f"{eng.stats()['quarantined']}")
    check(len(failed) == 1 and diag.get("reason") == "validity_guard"
          and len(healthy) == slots - 1
          and eng.stats()["quarantined"] == 1,
          "forecast poison: not exactly one slot quarantined with the "
          "others bit-equal to solo")
    del eng, res

    # ---- (d) an injected native compile failure reaches the reference ---
    inj = FaultInjector([FaultSpec(kind="compile_fail", op="dycore",
                                   attempt="native")])
    eng = ForecastEngine(slots=slots, device=dev, fault_injector=inj)
    work = [(request_state("float32", 400 + i), 2) for i in range(2)]
    _build.reset_launches()
    rids = [eng.submit(ForecastRequest(program=prog, state=s, steps=n))
            for s, n in work]
    res = eng.drain()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    ref_prog = wprog.reference_program(prog)
    same = [rid for rid, (s, n) in zip(rids, work)
            if equal_states(res[rid].state, solo(ref_prog, s, n))]
    st_ = eng.stats()
    say(f"forecast compile_fail on native: plan_fallbacks "
        f"{st_['plan_fallbacks']}, fallback_compiles "
        f"{st_['fallback_compiles']}, launches {counts}, {len(same)} of "
        f"{len(rids)} results bit-equal to solo runs of the reference plan")
    check(st_["plan_fallbacks"] == {"dycore": "reference"}
          and st_["fallback_compiles"] == 1
          and counts == {"slot_guard": st_["rounds"]}
          and len(same) == len(rids),
          "forecast compile_fail: the reference stage was not reached, "
          "counted and exact")
    del eng, res

    # ---- (e) a mid-drain checkpoint and restore -------------------------
    work = [(request_state("float32", 500 + i), int(n)) for i, n in
            enumerate(rng.integers(FORECAST_STEPS[0], FORECAST_STEPS[1] + 1,
                                   slots + 2))]
    ref_eng = ForecastEngine(slots=slots, device=dev)
    for s, n in work:
        ref_eng.submit(ForecastRequest(program=prog, state=s, steps=n))
    want = ref_eng.drain()
    del ref_eng
    d = ROOT / "build" / f"forecast-ckpt-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    eng = ForecastEngine(slots=slots, device=dev, ckpt_dir=str(d))
    for s, n in work:
        eng.submit(ForecastRequest(program=prog, state=s, steps=n))
    eng.pump()
    eng.pump()
    t0 = time.perf_counter()
    step = eng.checkpoint()
    save_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in (d / f"step_{step:08d}").iterdir())
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = ForecastEngine.restore(str(d), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = eng.drain()
    same = [rid for rid in want if rid in got and got[rid].status == "ok"
            and equal_states(got[rid].state, want[rid].state)]
    results[("forecast_checkpoint", "float32")] = dict(
        bytes=nbytes, save_s=save_s, restore_s=restore_s)
    say(f"forecast checkpoint after 2 rounds: {nbytes / 1e9:.3f} GB in "
        f"{save_s:.3f} s, restored in {restore_s:.3f} s; {len(same)} of "
        f"{len(want)} results bit-equal to the uninterrupted drain")
    check(len(same) == len(want) == len(got),
          "forecast checkpoint/restore: the resumed drain differs from "
          "the uninterrupted one")
    shutil.rmtree(d, ignore_errors=True)
    del eng, got, want
    torch.cuda.empty_cache()

    # ---- (f) LM training resumed from a checkpoint on the card ----------
    cfg = registry.reduced_config(registry.get_config("tinyllama-1.1b"))
    model = api.build(cfg, device=dev)
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    d = ROOT / "build" / f"fit-ckpt-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)

    def fit(steps, ckpt_dir=None):
        data = synthetic.iterator(cfg, 2, 64, prefetch=0, device=dev)
        return loop.fit(model, data, steps=steps, opt_cfg=opt_cfg,
                        ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0,
                        log_fn=lambda *_: None)

    p_a, o_a, h_a = fit(4)
    p_b, _, _ = fit(4)
    fit(2, str(d))                                 # "crash" after step 2
    p_r, o_r, h_r = fit(4, str(d))                 # resumes from step 2
    same = all(torch.equal(a, b) for a, b in
               zip(p_a.parameters(), p_r.parameters())) and all(
        torch.equal(o_a[part][k], o_r[part][k])
        for part in ("m", "v", "master") for k in o_a[part])
    repeat = all(torch.equal(a, b) for a, b in
                 zip(p_a.parameters(), p_b.parameters()))
    say(f"fit resume (reduced tinyllama-1.1b, {cfg.n_layers} layers, "
        f"bf16, 4 steps, ckpt_every 2): checkpoints {ckpt.all_steps(str(d))}"
        f", resumed steps {[h['step'] for h in h_r]}, parameters and "
        f"optimizer state bit-equal to the uninterrupted run: {same} (two "
        f"uninterrupted runs bit-equal: {repeat})")
    check(same and [h["loss"] for h in h_r] == [h["loss"] for h in h_a[2:]],
          "fit resume: the resumed run differs from the uninterrupted one")
    shutil.rmtree(d, ignore_errors=True)
    del model, p_a, p_b, p_r, o_a, o_r
    torch.cuda.empty_cache()
    return forecast_launches


def family_config(arch):
    """`arch`'s published config at full width, and its depth cut (None
    where every layer fits): the most layers whose bf16 weights fit
    FAMILY_WEIGHTS_GB, at least FAMILY_MIN_LAYERS."""
    from repro_torch.configs import registry

    full = registry.get_config(arch)
    gb = lambda c: 2 * c.param_count() / 1e9
    if gb(full) <= FAMILY_WEIGHTS_GB:
        return full, None
    layers = max([FAMILY_MIN_LAYERS] + [
        n for n in range(1, full.n_layers)
        if gb(dataclasses.replace(full, n_layers=n)) <= FAMILY_WEIGHTS_GB])
    cfg = dataclasses.replace(full, n_layers=layers)
    return cfg, (f"{arch}: depth cut to {layers} of {full.n_layers} layers "
                 f"at full width: {gb(cfg):.2f} GB of bf16 weights "
                 f"({cfg.param_count() / 1e9:.2f} B parameters) of "
                 f"{gb(full):.2f} GB in all, which would not fit the card's "
                 f"80 GB beside the cache")


def family_phase(torch, dev, check, results):
    """The five LM configurations phases 6 and 7 do not run (phase 9): the
    flash kernel at their prefill shapes against its plain version and
    timed beside SDPA (whisper's non-causal encoder, granite's GQA group
    of 3, moonshot at head_dim 128, qwen2-vl's group of 8); `ServeEngine`
    over each at full width in bf16 (`serve_model`: planned launches, the
    stepwise loop, a profiler split with the MoE and SSD ranges, the
    engine's times); granite-moe-3b trained at full width and depth
    (`train_model`); and each family's reduced fp32 train step on the card
    against the CPU. Returns the serving and training paths' launches, by
    arch."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_attention.flash import flash_mha_cuda
    from repro_torch.models import api, lm

    gen = torch.Generator(device=dev).manual_seed(9)
    plen = max(map(len, serve_prompts(family_config(FAMILY_ARCHS[0])[0])))

    # ---- (a) the flash kernel at the families' prefill shapes ------------
    # whisper's is its encoder's (non-causal, T = S = the frames); mamba2
    # runs no attention
    for arch in ("whisper-medium", "granite-moe-3b-a800m",
                 "moonshot-v1-16b-a3b", "qwen2-vl-72b"):
        cfg = family_config(arch)[0]
        t = cfg.encdec.encoder_len if cfg.encdec else plen
        causal = not cfg.encdec
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        label = (f"{arch} {'encoder' if cfg.encdec else 'prefill'} (H {h}, "
                 f"KH {kh}, hd {hd}{'' if causal else ', non-causal'})")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((SERVE_SLOTS, t, h, hd),
                                     (SERVE_SLOTS, t, kh, hd),
                                     (SERVE_SLOTS, t, kh, hd)))
            want = flash_ref.mha(q.float(), k.float(), v.float(),
                                 causal=causal)
            rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -8
            ok, err = within(flash_mha_cuda(q, k, v, causal=causal), want,
                             rtol)
            say(f"flash {label} {tuple(q.shape)}/{tuple(k.shape)} "
                f"{str(dtype)[6:]}: err {err:.3g} (atol 2e-5 + "
                f"{rtol:.3g}|want|)")
            check(ok, f"flash {label} {dtype}: disagrees with its plain "
                  f"version")
            del want
        time_flash(torch, results, f"flash_attn_{arch}", label, q, k, v,
                   err, causal)
        del q, k, v
    torch.cuda.empty_cache()

    # ---- (b) serving at full width ----------------------------------------
    serve_launches = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg, cut = family_config(arch)
        if cut:
            say(cut)
        n_attn = sum(kd not in ("rec", "ssd") for kd in lm.layer_kinds(cfg))
        if cfg.encdec:
            n_attn += cfg.encdec.encoder_layers
        torch.cuda.reset_peak_memory_stats()
        model = api.build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        t1 = time.perf_counter()
        serve_launches[arch] = serve_model(torch, dev, check, results, model,
                                           params, n_attn, 0, n_dec=2)
        results[(f"serve_{cfg.name}", cfg.dtype)].update(
            layers=cfg.n_layers,
            published_layers=registry.get_config(arch).n_layers)
        del model, params
        torch.cuda.empty_cache()
        say(f"serve {arch}: {time.perf_counter() - t0:.1f} s in all (init "
            f"{t1 - t0:.1f} s)")

    # ---- (c) training at full width and depth -----------------------------
    t0 = time.perf_counter()
    arch, steps = FAMILY_TRAIN
    train_launches = {arch: train_model(torch, dev, check, results,
                                        family_config(arch)[0], steps, gen)}
    torch.cuda.empty_cache()
    say(f"train {arch}: {time.perf_counter() - t0:.1f} s in all")

    # ---- (d) reduced configs, fp32: one step on the card vs the CPU -------
    t0 = time.perf_counter()
    for arch in FAMILY_ARCHS:
        reduced_train_step(torch, dev, check, arch)
    torch.cuda.empty_cache()
    say(f"reduced train steps: {time.perf_counter() - t0:.1f} s")
    return serve_launches, train_launches


def mesh_category(name: str) -> str:
    """The group a device kernel of a mesh round is reported under (a
    kernel launched inside the exchange's `halo_exchange` range goes under
    that range instead): each stencil kernel, a copy (the crop), the
    point-wise work (the staggered sum, an update)."""
    n = name.lower()
    for kernel, cat in (("dycore_fused", "dycore_fused"),
                        ("dycore_kstep", "dycore_kstep"),
                        ("hdiff_stream", "hdiff"), ("vadvc_stream", "vadvc"),
                        ("hadv_stream", "hadv")):
        if kernel in n:
            return cat
    if "memcpy" in n or "cat" in n or "copy" in n:
        return "copy"
    if "mul" in n or "add" in n:
        return "pointwise"
    return "other"


def forecast_mesh_category(name: str) -> str:
    """`mesh_category`, with the slot guard's partial and combine kernels
    under "slot_guard"."""
    if "guard_partial" in name or "guard_finish" in name:
        return "slot_guard"
    return mesh_category(name)


def remat_steps(torch, dev, check, results, cfg):
    """One training step (loss, gradients, AdamW) of `cfg` at TRAIN_BATCH x
    TRAIN_SEQ in bf16 under each of REMATS: the step's time (host clock to
    a synchronise, median of REMAT_STEPS after a warm-up step), its peak
    device memory above what was resident before it (weights, gradients'
    home, optimizer state), its launches and loss. "dots" keeps the 2-D
    products' outputs for the backward and recomputes the rest, so its
    peak should fall between "full"'s and "none"'s."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.train import loop, optim

    model = api.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    opt_state = optim.init_opt_state(params)
    batch = next(synthetic.iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                    device=dev))
    out = {}
    for remat in REMATS:
        step = loop.make_train_step(model, opt_cfg, remat=remat)
        params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        each = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v // REMAT_STEPS for k, v in _build.LAUNCHES.items()
                    if v}
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        out[remat] = dict(step_ms=statistics.median(each), step_ms_each=each,
                          peak_gb=peak, launches_per_step=launches,
                          loss=float(m["loss"]))
        say(f"remat {cfg.name} {remat}: step {out[remat]['step_ms']:.1f} ms "
            f"(each {[round(x, 1) for x in each]}), peak {peak:.2f} GB above "
            f"the {resident / 1e9:.2f} GB resident, launches a step "
            f"{launches}, loss {out[remat]['loss']:.4f}")
    peaks = [out[r]["peak_gb"] for r in ("full", "dots", "none")]
    check(peaks[0] < peaks[1] < peaks[2],
          f"remat {cfg.name}: peaks full/dots/none {peaks} GB are not in "
          f"that order")
    results[(f"remat_{cfg.name}", "bfloat16")] = out
    del model, params, opt_state, batch
    torch.cuda.empty_cache()


def mesh_phase(torch, dev, check, results, make_state):
    """Phase 10: the weather plans on a mesh of MESH_SHAPE shards, all on
    this one card. The main path's domain, `run(state, STEPS)` in fp32, bf16
    and with a bf16 wire, each against the single-device plan's; the
    resolved k's round against k whole-state rounds; one round of each
    MESH_OPS plan and of the flagship chain against its single-device
    plan. Launches and rides counted against the reports; the mesh round
    timed beside the single-device step, and the exchange's device and
    host share read under the profiler. Returns the launches of each
    kernel on the mesh paths, by plan."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weather import domain
    from repro_torch.weather.pipeline import PipelineProgram
    from repro_torch.weather.program import StencilProgram, compile

    mesh = make_mesh(MESH_SHAPE, ("data", "model"), devices=[dev] * 4)
    shards = mesh.size
    say(f"mesh: {mesh}: four shards on ONE card "
        f"({torch.cuda.get_device_name(0)}); every ride is a copy within its "
        f"memory, so nothing in this phase measures an interconnect")
    by_plan = {}

    def count(label, counts):
        for name, n in counts.items():
            by_plan.setdefault(name, {})[label] = n

    def held(label, got, want, tol, allow=None):
        """Gathered `got` against `want` (either device): each field and
        stage tendency within `tol`, or with `allow` at most that many
        points a tensor over `tol` and every point within LOOSE. Returns
        (largest error, bit for bit)."""
        worst, bitwise, ok = 0.0, True, True
        for part in ("fields", "stage_tens"):
            for n in getattr(want, part):
                a = getattr(got, part)[n].cpu()
                b = getattr(want, part)[n].cpu()
                bitwise &= torch.equal(a, b)
                err = (a.float() - b.float()).abs()
                m = float(err.max())
                worst = max(worst, m)
                if allow is None:
                    ok &= m <= tol
                else:
                    ok &= int((err > tol).sum()) <= allow and m < LOOSE
        rule = (f"atol {tol}" if allow is None else
                f"at most {allow} points a tensor over {tol}, all < {LOOSE}")
        say(f"{label}: err {worst:.3g} ({rule}); bit for bit {bitwise}")
        check(ok, f"{label}: disagrees with the single-device plan")
        return worst, bitwise

    def timed(fn):
        return dict(ms=time_ms(fn), queued_ms=stream_ms(fn, n=20))

    def profiled(fn):
        br = device_breakdown(fn, mesh_category)
        if br is None:
            say("mesh: the profiler saw no device kernel (not measured)")
            return None
        ex_dev = br["by_category_ms"].get("halo_exchange", 0.0)
        ex_host = br["host_range_ms"].get("halo_exchange", 0.0)
        br.update(exchange_device_ms=ex_dev, exchange_host_ms=ex_host,
                  exchange_device_share=ex_dev / br["busy_ms"],
                  exchange_host_share=ex_host / br["wall_ms"])
        return br

    # ---- the main path's domain, run(state, STEPS) -----------------------
    fp32_out = None
    for dtype, wire in (("float32", None), ("bfloat16", None),
                        ("float32", "bfloat16")):
        key = dtype if wire is None else f"{dtype}_wire_{wire}"
        label = f"mesh dycore {key}"
        st = make_state(dtype, seed=12)
        prog = StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE, dtype=dtype,
                              k_steps=1, exchange_dtype=wire)
        plan = compile(prog, mesh=mesh)
        rep = plan.report()
        check(plan.variant == "whole_state" and plan.k_steps == 1,
              f"{label}: resolved to {plan.variant}/k={plan.k_steps}")
        sharded = domain.shard_state(st, mesh, plan.state_spec)
        torch.cuda.synchronize()
        _build.reset_launches()
        domain.reset_rides()
        out = plan.run(sharded, STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        rides = dict(domain.RIDES)
        want = {"dycore_fused": STEPS * shards * plan.pallas_calls_per_round}
        say(f"{label}: run({STEPS}) on {shards} shards of "
            f"{list(plan.local_grid)} (kernel on {list(plan.compute_grid)}, "
            f"tile {plan.tile.ty}x{plan.tile.tx}): launches {counts} "
            f"(expect {want}: one a shard a round), rides {rides['rides']} "
            f"moving {rides['bytes']} bytes (expect {STEPS} x "
            f"{plan.collectives_per_round}); exchange {rep['exchange']}")
        check(counts == want, f"{label}: launched {counts}, expected {want}")
        check(rides["rides"] == STEPS * plan.collectives_per_round,
              f"{label}: {rides['rides']} rides, report says "
              f"{plan.collectives_per_round} a round")
        count(f"dycore {key} run({STEPS})", counts)
        got = domain.gather_state(out)
        check(all(tuple(got.fields[n].shape) == (ENSEMBLE,) + GRID
                  and bool(torch.isfinite(got.fields[n]).all())
                  for n in got.fields), f"{label}: bad shape or not finite")
        single = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                        dtype=dtype, k_steps=1))
        if wire is None:
            err, bitwise = held(f"{label} run({STEPS}) vs the single-device "
                                f"plan's", got, single.run(st, STEPS), 1e-5,
                                allow=2)
        else:
            err = max(float((got.fields[n] - fp32_out.fields[n]).abs().max())
                      for n in got.fields)
            bitwise = False
            say(f"{label} run({STEPS}) vs the fp32 wire's: field err "
                f"{err:.3g} (the cast stays in the halo: 0 < err < 0.1)")
            check(0.0 < err < 0.1, f"{label}: the bf16 wire moved the "
                  f"result by {err}")
        if dtype == "float32" and wire is None:
            fp32_out = got
        mesh_t = timed(lambda: plan.step(sharded))
        single_t = timed(lambda: single.step(st))
        br = profiled(lambda: [plan.step(sharded) for _ in range(5)])
        results[("mesh_dycore", key)] = dict(
            err=err, bitwise=bitwise, launches=counts, rides=rides,
            round_ms=mesh_t["ms"], round_queued_ms=mesh_t["queued_ms"],
            single_ms=single_t["ms"], single_queued_ms=single_t["queued_ms"],
            wire_bytes_per_round=rides["bytes"] // STEPS,
            exchange_model=rep["exchange_model"], profile=br)
        say(f"{label}: mesh round {mesh_t['ms']:.4f} ms by call, "
            f"{mesh_t['queued_ms']:.4f} ms queued; single-device step "
            f"{single_t['ms']:.4f} ms by call, {single_t['queued_ms']:.4f} ms "
            f"queued")
        if br is not None:
            say(f"{label} under torch.profiler (5 rounds): host window "
                f"{br['wall_ms']:.2f} ms, device busy {br['busy_ms']:.2f} ms "
                f"(idle share {br['idle_share']:.3f}); exchange device "
                f"{br['exchange_device_ms']:.3f} ms (share of busy "
                f"{br['exchange_device_share']:.3f}), exchange host "
                f"{br['exchange_host_ms']:.2f} ms (share of the window "
                f"{br['exchange_host_share']:.3f}); by kind (ms) "
                + ", ".join(f"{k} {v:.3f}"
                            for k, v in br["by_category_ms"].items()))
        del st, sharded, out, got
        torch.cuda.empty_cache()

    # ---- the resolved k: its round against k whole-state rounds ---------
    auto = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE),
                   mesh=mesh)
    say(f"mesh dycore k_steps='auto' resolves to k={auto.k_steps} "
        f"({auto.variant}) on {shards} shards (the exchange model under "
        f"the default spec, walked down to what the CUDA k-step kernel "
        f"takes)")
    kplan = auto if auto.k_steps > 1 else compile(
        StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE, variant="kstep",
                       k_steps=2), mesh=mesh)
    k = kplan.k_steps
    one = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                 k_steps=1), mesh=mesh)
    st = make_state("float32", seed=13)
    sharded = domain.shard_state(st, mesh, kplan.state_spec)
    torch.cuda.synchronize()
    _build.reset_launches()
    domain.reset_rides()
    out = kplan.step(sharded)
    torch.cuda.synchronize()
    counts = {n: v for n, v in _build.LAUNCHES.items() if v}
    rides = domain.RIDES["rides"]
    check(counts == {"dycore_kstep": shards},
          f"mesh dycore k={k}: launched {counts}")
    check(rides == kplan.collectives_per_round,
          f"mesh dycore k={k}: {rides} rides, report "
          f"{kplan.collectives_per_round}")
    count(f"dycore k={k} round", counts)

    def k_rounds():
        s = sharded
        for _ in range(k):
            s = one.step(s)
        return s
    err, bitwise = held(f"mesh dycore k={k} round vs {k} whole-state mesh "
                        f"rounds", domain.gather_state(out),
                        domain.gather_state(k_rounds()), 1e-5, allow=2)
    kt, seq_t = timed(lambda: kplan.step(sharded)), timed(k_rounds)
    results[("mesh_dycore_kstep", "float32")] = dict(
        k=k, auto_k=auto.k_steps, err=err, bitwise=bitwise,
        round_ms=kt["ms"], round_queued_ms=kt["queued_ms"],
        whole_state_rounds_ms=seq_t["ms"],
        whole_state_rounds_queued_ms=seq_t["queued_ms"],
        rides_per_round=rides, launches=counts)
    say(f"mesh dycore k={k} round: {kt['ms']:.4f} ms by call "
        f"({kt['queued_ms']:.4f} queued) against {k} whole-state mesh rounds "
        f"{seq_t['ms']:.4f} ms ({seq_t['queued_ms']:.4f} queued); rides "
        f"{rides} a round")
    del st, sharded, out
    torch.cuda.empty_cache()

    # ---- one round of each op's mesh plan and of the flagship chain -----
    st = make_state("float32", seed=14)
    for op in MESH_OPS + ("flagship",):
        if op == "flagship":
            prog = PipelineProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                   stages=PIPELINE, variant="whole_state",
                                   k_steps=1)
        else:
            prog = StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE, op=op,
                                  k_steps=1)
        plan = compile(prog, mesh=mesh)
        sharded = domain.shard_state(st, mesh, plan.state_spec)
        torch.cuda.synchronize()
        _build.reset_launches()
        domain.reset_rides()
        out = plan.step(sharded)
        torch.cuda.synchronize()
        counts = {n: v for n, v in _build.LAUNCHES.items() if v}
        rides = domain.RIDES["rides"]
        label = f"mesh {op}"
        say(f"{label}: launches {counts} ({plan.pallas_calls_per_round} a "
            f"shard), rides {rides} (report {plan.collectives_per_round})")
        check(sum(counts.values()) == shards * plan.pallas_calls_per_round,
              f"{label}: launched {counts}")
        check(rides == plan.collectives_per_round,
              f"{label}: {rides} rides, report {plan.collectives_per_round}")
        count(f"{op} round", counts)
        single = compile(prog)
        err, bitwise = held(f"{label} round vs the single-device plan's",
                            domain.gather_state(out), single.step(st),
                            MESH_TOL[op],
                            allow=2 if op == "flagship" else None)
        mt, stt = timed(lambda: plan.step(sharded)), timed(
            lambda: single.step(st))
        results[(f"mesh_{op}", "float32")] = dict(
            err=err, bitwise=bitwise, launches=counts, rides=rides,
            round_ms=mt["ms"], round_queued_ms=mt["queued_ms"],
            single_ms=stt["ms"], single_queued_ms=stt["queued_ms"])
        say(f"{label}: mesh round {mt['ms']:.4f} ms by call "
            f"({mt['queued_ms']:.4f} queued), single-device step "
            f"{stt['ms']:.4f} ms ({stt['queued_ms']:.4f} queued)")
        if op == "flagship":
            # the chain's one exchange a round against its stages' own
            # mesh plans, each with its exchange: bit for bit, and timed
            solos = [compile(StencilProgram(grid_shape=GRID,
                                            ensemble=ENSEMBLE, op=o,
                                            k_steps=1), mesh=mesh)
                     for o in PIPELINE]

            def solo_rounds():
                s = sharded
                for p in solos:
                    s = p.step(s)
                return s
            domain.reset_rides()
            seq = domain.gather_state(solo_rounds())
            solo_rides = domain.RIDES["rides"]
            got = domain.gather_state(out)
            same = all(torch.equal(getattr(got, part)[n],
                                   getattr(seq, part)[n])
                       for part in ("fields", "stage_tens")
                       for n in got.fields)
            check(same, f"{label}: the chain's mesh round differs from its "
                  f"stages' mesh plans in sequence")
            solo_t = timed(solo_rounds)
            results[(f"mesh_{op}", "float32")].update(
                solo_mesh_ms=solo_t["ms"],
                solo_mesh_queued_ms=solo_t["queued_ms"],
                solo_mesh_rides=solo_rides)
            say(f"{label}: its stages' own mesh plans in sequence "
                f"{solo_t['ms']:.4f} ms by call ({solo_t['queued_ms']:.4f} "
                f"queued), {solo_rides} rides against the chain's {rides}; "
                f"fields and stage tendencies bit for bit {same}")
        del sharded, out
    del st
    torch.cuda.empty_cache()
    return by_plan


def forecast_mesh_phase(torch, dev, check, results, card):
    """Phase 11: the forecast engine on a mesh of MESH_SHAPE shards, all on
    this one card (four logical devices, no interconnect). The guard kernel
    with offsets against its plain version on each shard's blocks and the
    combined digest against the single-device kernel's, timed; a dycore
    fp32 lane, a bf16 lane (FORECAST_REQUESTS requests each, steps from a
    seed, as phase 8 draws them) and an `op="hdiff"` lane of ENSEMBLE, every
    result bit-equal to its solo mesh `run` and to the single-device plan's
    at the lane's round strategy (fp32 also to the single-device k=1
    plan's; bf16 within 0.15 of it: a k-step round rounds once), each lane
    round's launches as planned (one step kernel a shard, the guard's
    partials and combine); a persistent loss of logical device 3
    failing over (2, 2) -> (2, 1) with every request bit-equal; a
    `wire_corrupt` in shard 1 of a rolled-back slot quarantined; a
    mid-drain checkpoint restored onto one device and onto (4, 1), both
    bit-equal; the steady mesh round, the guard's share, admit and retire
    and the failover's reshard. Returns the drain's launches."""
    import shutil

    import numpy as np

    from repro_torch.core import tiling
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_guard import ref as guard_ref
    from repro_torch.kernels.slot_guard.slot_guard import (
        slot_guard_blocks_cuda, slot_guard_cuda)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.forecast import ForecastEngine, ForecastRequest
    from repro_torch.testing.faults import FaultInjector, FaultSpec
    from repro_torch.weather import domain, fields
    from repro_torch.weather import program as wprog

    limit = 1e6
    slots = ENSEMBLE
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), devices=[dev] * 4)
    spec = (None, None, "data", "model")
    say(f"forecast mesh: {mesh}: four logical devices (ids "
        f"{list(mesh.ids)}) on ONE card ({card}); no interconnect is "
        f"measured")
    rng = np.random.default_rng(27)

    def quiet(fn):
        """`fn()` whose launches are not the path's."""
        n = _build.LAUNCHES["slot_guard"]
        out = fn()
        _build.LAUNCHES["slot_guard"] = n
        return out

    # ---- (a) the guard: each shard's blocks, the combine ------------------
    for dtype in ("float32", "bfloat16"):
        gen = torch.Generator(device=dev).manual_seed(27)
        st = fields.initial_state(gen, GRID, slots, dtype=dtype, device=dev)
        nz, ny, nx = GRID
        st.fields["u"][1, nz - 1, ny * 3 // 4, 7] = float("nan")   # shard 2
        st.tens["t"][2, 0, 5, nx - 6] = 2 * limit                 # shard 1
        sharded = domain.shard_state(st, mesh, spec)
        offsets = domain.block_offsets(sharded)
        thr = guard_ref.threshold(fields.torch_dtype(dtype), limit)
        worst = 0
        for s, (e0, y0, x0) in enumerate(offsets):
            leaves = fields.state_leaves(sharded.shards[s])
            got = quiet(lambda: slot_guard_blocks_cuda(
                [(leaves, e0, y0, x0)], slots, limit))
            want = guard_ref.guard_finish(
                guard_ref.guard_words(leaves, y0, x0)[None], thr)
            worst = max([worst] + [abs(int(a) - int(b)) for a, b in zip(
                got[0].tolist() + got[1].tolist(),
                want[0].tolist() + want[1].tolist())])
        check(worst == 0, f"forecast mesh guard {dtype}: a shard's kernel "
              f"words differ from the plain version's by {worst}")
        ok, fp = quiet(lambda: wprog.slot_guard(sharded, limit))
        w_ok, w_fp = quiet(lambda: slot_guard_cuda(
            fields.state_leaves(st), limit))
        same = ok.tolist() == w_ok.tolist() and fp.tolist() == w_fp.tolist()
        check(same and ok.tolist() == [True, False, False, True],
              f"forecast mesh guard {dtype}: combined {ok.tolist()} "
              f"{fp.tolist()} against the single-device kernel's "
              f"{w_ok.tolist()} {w_fp.tolist()}")
        leaves0 = fields.state_leaves(sharded.shards[0])
        one = lambda: slot_guard_blocks_cuda([(leaves0,) + offsets[0]],
                                             slots, limit)
        whole = lambda: wprog.slot_guard(sharded, limit)
        shard_ms, shard_q = quiet(lambda: time_ms(one)), quiet(
            lambda: stream_ms(one))
        mesh_ms, mesh_q = quiet(lambda: time_ms(whole)), quiet(
            lambda: stream_ms(whole))
        nbytes = sum(t.numel() * t.element_size()
                     for t in fields.state_leaves(st))
        bound_ms, _ = bound(nbytes, 0.0)
        results[("forecast_mesh_guard", dtype)] = dict(
            err=float(worst), shard_ms=shard_ms, shard_queued_ms=shard_q,
            ms=mesh_ms, queued_ms=mesh_q, bound_ms=bound_ms,
            shard_bound_ms=bound_ms / 4, launches_per_call=5,
            bit_equal_to_single_device=same)
        shape = list(sharded.shards[0].wcon.shape)
        say(f"forecast mesh guard {dtype}: 4 shards of {shape} x 13 "
            f"leaves; each shard's kernel with its offset bit-equal to "
            f"the plain version (ok, digest); the combined digest equal to "
            f"the single-device kernel's: {same}; one shard (partial + "
            f"combine) {shard_ms:.4f} ms by call, {shard_q:.4f} queued "
            f"(bound {bound_ms / 4:.4f}); the mesh guard (4 partials + 1 "
            f"combine) {mesh_ms:.4f} ms by call, {mesh_q:.4f} queued (bound "
            f"{bound_ms:.4f} ms, bytes) [{card}]")
        del st, sharded
    torch.cuda.empty_cache()

    # ---- (b) the served mix on the mesh -----------------------------------
    class Recorded(ForecastEngine):
        """The engine with each lane round's launches and host time, and
        each admission's and retirement's host time, recorded."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log, self.admit_s, self.retire_s = [], [], []

        def _admit(self):
            n = self._stats["admitted"]
            t0 = time.perf_counter()
            super()._admit()
            torch.cuda.synchronize()
            if self._stats["admitted"] > n:
                self.admit_s.append((time.perf_counter() - t0,
                                     self._stats["admitted"] - n))

        def _retire(self, lane, i):
            t0 = time.perf_counter()
            super()._retire(lane, i)
            self.retire_s.append((lane.key.dtype, time.perf_counter() - t0))

        def _round(self, lane):
            plan = self._plan_for(lane.key)
            kk = min(min(s.remaining, plan.k_steps)
                     for s in lane.slots if s is not None)
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            super()._round(lane)
            self.log.append(dict(
                key=lane.key, kk=kk, s=time.perf_counter() - t0,
                plan=plan.round_plan(kk), launches={
                    k: v - before[k] for k, v in _build.LAUNCHES.items()
                    if v != before[k]}))

    def request_state(dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        st = fields.initial_state(g, GRID, 1, dtype=dtype, device=dev)
        return wprog.map_state(st, lambda t: t.cpu())

    plans = {}

    def solo(prog, state, steps, where, pin=None):
        """The solo run of `state` on the mesh or on one device, on the
        CPU; with `pin`, on one device at that round strategy (the lane's
        variant and k, as a restore onto one device compiles it)."""
        if pin:
            prog = dataclasses.replace(prog, **pin)
        key = (prog, where)
        if key not in plans:
            plans[key] = (wprog.compile(prog, mesh=mesh) if where == "mesh"
                          else wprog.compile(prog, device=dev))
        plan = plans[key]
        if where == "mesh":
            return domain.gather_state(plan.run(
                domain.shard_state(state, mesh, plan.state_spec), steps))
        out = plan.run(wprog.map_state(state, lambda t: t.to(dev)), steps)
        return wprog.map_state(out, lambda t: t.cpu())

    def equal(a, b):
        la, lb = fields.state_leaves(a), fields.state_leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(x, y) for x, y in zip(la, lb))

    programs = {"dycore float32": wprog.StencilProgram(grid_shape=GRID),
                "dycore bfloat16": wprog.StencilProgram(grid_shape=GRID,
                                                        dtype="bfloat16"),
                "hdiff float32": wprog.StencilProgram(grid_shape=GRID,
                                                      op="hdiff")}
    mix = []
    for name in ("dycore float32", "dycore bfloat16"):
        mix += [(name, int(s)) for s in rng.integers(
            FORECAST_STEPS[0], FORECAST_STEPS[1] + 1, FORECAST_REQUESTS)]
    mix += [("hdiff float32", int(s)) for s in rng.integers(
        FORECAST_STEPS[0], FORECAST_STEPS[1] + 1, slots)]
    states = [request_state(programs[n].dtype, 1100 + i)
              for i, (n, _) in enumerate(mix)]
    eng = Recorded(slots=slots, mesh=mesh)
    rids = [eng.submit(ForecastRequest(program=programs[n], state=s,
                                       steps=k))
            for (n, k), s in zip(mix, states)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    stats = eng.stats()
    pins = {n: eng._pinned[wprog.plan_cache_key(p, ensemble=slots)]
            for n, p in programs.items()}
    ks = {n: pin["k_steps"] for n, pin in pins.items()}
    say(f"forecast mesh mix: {len(mix)} requests on {slots} slots of the "
        f"mesh (k by lane {ks}), {stats['rounds']} lane rounds in "
        f"{drain_s:.3f} s; launches {launches}; stats "
        + str({k: stats[k] for k in (
            "admitted", "completed", "rolled_back_slot_rounds",
            "quarantined", "scrubbed_idle_slots", "fingerprint_divergence",
            "fallback_compiles", "round_retries", "mesh_devices")}))
    bad = [rid for rid in rids if res[rid].status != "ok"]
    check(not bad, f"forecast mesh mix: requests {bad} did not finish ok")
    unequal, k1_err = [], {}
    for rid, (n, k), s in zip(rids, mix, states):
        if not equal(res[rid].state, solo(programs[n], s, k, "mesh")):
            unequal.append((rid, "mesh"))
        if not equal(res[rid].state, solo(programs[n], s, k, "single",
                                          pins[n])):
            unequal.append((rid, "single"))
        if pins[n]["k_steps"] > 1:
            # the single-device auto plan (k = 1): its own rounding in bf16
            got, one = res[rid].state, solo(programs[n], s, k, "single")
            k1_err[n] = max([k1_err.get(n, 0.0)] + [
                float((got.fields[f].float() - one.fields[f].float()).abs()
                      .max()) for f in got.fields])
    say(f"forecast mesh mix: {len(rids) - len({r for r, _ in unequal})} of "
        f"{len(rids)} results bit-equal to their solo mesh run and to the "
        f"single-device plan's run at the lane's round strategy (pins "
        f"{pins}); against the single-device k=1 plan the largest field "
        f"difference is {k1_err} (0.0: bit for bit)")
    check(not unequal, f"forecast mesh mix: results differ from their solo "
          f"runs: {unequal[:6]}")
    check(all(v == 0.0 for n, v in k1_err.items() if "float32" in n)
          and all(v < 0.15 for v in k1_err.values()),
          f"forecast mesh mix: against the single-device k=1 plan {k1_err}")
    step_kernel = {("dycore", False): "dycore_fused",
                   ("dycore", True): "dycore_kstep",
                   ("hdiff", False): "hdiff", ("hdiff", True): "hdiff_kstep"}
    wrong = []
    for e in eng.log:
        p = e["plan"]
        # a k-step hdiff round longer than a launch takes is several
        n = (len(tiling.hdiff_launches(p.k_steps)) if e["key"].op == "hdiff"
             and p.variant == "kstep" else p.pallas_calls_per_round)
        want = {step_kernel[(e["key"].op, p.variant == "kstep")]: 4 * n,
                "slot_guard": 5}
        if e["launches"] != want:
            wrong.append((e["key"].op, e["key"].dtype, e["kk"],
                          e["launches"], want))
    check(not wrong, f"forecast mesh mix: lane rounds launched other than "
          f"one step kernel a shard and the guard's 4 + 1: {wrong[:4]}")
    for key in ("fallback_compiles", "scrubbed_idle_slots",
                "fingerprint_divergence", "quarantined", "round_retries",
                "mesh_failovers"):
        check(stats[key] == 0, f"forecast mesh mix: stats {key} = "
              f"{stats[key]}")
    check(stats["plan_fallbacks"] == {}, f"forecast mesh mix: fallbacks "
          f"{stats['plan_fallbacks']}")
    retire = {dt: [t * 1e3 for d_, t in eng.retire_s if d_ == dt]
              for dt in ("float32", "bfloat16")}
    admit = statistics.median(t / n for t, n in eng.admit_s) * 1e3
    mix_launches = dict(launches)
    want_res = {rid: res[rid] for rid in rids}
    del eng, res
    torch.cuda.empty_cache()

    # ---- (b2) the steady mesh round ----------------------------------------
    # 4 requests of MESH_STEADY_STEPS steps on one lane: the rounds after
    # the first on the host clock, then MESH_PROFILED_ROUNDS more under the
    # profiler, all before any retirement
    prog = programs["dycore float32"]
    eng = Recorded(slots=slots, mesh=mesh)
    for i in range(slots):
        eng.submit(ForecastRequest(program=prog, state=request_state(
            "float32", 1200 + i), steps=MESH_STEADY_STEPS))
    eng.pump()
    key = wprog.plan_cache_key(prog, ensemble=slots)
    k = eng._plans[key].k_steps
    steady = MESH_STEADY_ROUNDS
    check(MESH_STEADY_STEPS // k > steady + MESH_PROFILED_ROUNDS + 1,
          f"forecast mesh round: k={k} leaves too few rounds")
    t0 = time.perf_counter()
    for _ in range(steady):
        eng.pump()
    back_to_back = (time.perf_counter() - t0) * 1e3 / steady
    rounds = [e["s"] * 1e3 for e in eng.log[1:]]
    rnd = statistics.median(rounds)
    br = device_breakdown(
        lambda: [eng.pump() for _ in range(MESH_PROFILED_ROUNDS)],
        forecast_mesh_category)
    eng.drain()
    guard = results[("forecast_mesh_guard", "float32")]
    single = results.get(("forecast_round", "float32"), {})
    mesh_k = results.get(("mesh_dycore_kstep", "float32"), {})
    results[("forecast_mesh_round", "float32")] = dict(
        k=k, round_ms=rnd, round_ms_each=rounds, back_to_back_ms=back_to_back,
        per_step_ms=rnd / k, guard_ms=guard["ms"],
        guard_share=guard["ms"] / rnd,
        single_device_round_ms=single.get("round_ms"),
        mesh_round_ms=mesh_k.get("round_ms"), admit_ms_per_request=admit,
        retire_ms={dt: statistics.median(v) for dt, v in retire.items()},
        retire_ms_each=retire, profile=br)
    say(f"forecast mesh round fp32: k={k} ({k} steps a round), median "
        f"{rnd:.4f} ms by call over {len(rounds)} steady rounds (range "
        f"{min(rounds):.4f}-{max(rounds):.4f}), {back_to_back:.4f} ms a round "
        f"back to back; {rnd / k:.4f} ms a step, against phase 8's "
        f"single-device round {single.get('round_ms', float('nan')):.4f} ms "
        f"(one step) and phase 10's k={mesh_k.get('k')} mesh round "
        f"{mesh_k.get('round_ms', float('nan')):.4f} ms; the mesh guard "
        f"{guard['ms']:.4f} ms by call, {guard['ms'] / rnd:.3f} of the "
        f"round [{card}]")
    if br is None:
        say("forecast mesh round: the profiler saw no device kernel (not "
            "measured)")
    else:
        n = MESH_PROFILED_ROUNDS
        say(f"forecast mesh round fp32 under torch.profiler ({n} rounds): "
            f"host window {br['wall_ms'] / n:.3f} ms a round, device busy "
            f"{br['busy_ms'] / n:.3f} ms a round (idle share "
            f"{br['idle_share']:.3f}); device ms a round by kind "
            + ", ".join(f"{c} {v / n:.3f}"
                        for c, v in br["by_category_ms"].items())
            + "; host ms a round in the exchange "
            + f"{br['host_range_ms'].get('halo_exchange', 0.0) / n:.3f}")
    say(f"forecast mesh host: admit {admit:.3f} ms a request (each shard's "
        f"block into its lane), retire {statistics.median(retire['float32']):.3f}"
        f" ms fp32, {statistics.median(retire['bfloat16']):.3f} ms bf16 "
        f"(medians; one slot gathered from four shards to host memory)")
    del eng
    torch.cuda.empty_cache()

    # ---- (c) a kill: logical device 3 lost for good at round 2 -------------
    picks = [i for dt in ("float32", "bfloat16")
             for i in [j for j, (n, _) in enumerate(mix)
                       if n == f"dycore {dt}"][:4]]
    inj = FaultInjector([FaultSpec(kind="device_loss", round=2, device=3,
                                   once=False)])
    eng = ForecastEngine(slots=slots, mesh=mesh, fault_injector=inj,
                         max_round_retries=1, retry_backoff_s=0.0)
    rids = {i: eng.submit(ForecastRequest(program=programs[mix[i][0]],
                                          state=states[i], steps=mix[i][1]))
            for i in picks}
    res = eng.drain()
    st_ = eng.stats()
    fos = st_["failovers"]
    fo = fos[0] if fos else {}
    same = [i for i in picks if res[rids[i]].status == "ok" and equal(
        res[rids[i]].state, want_res[i].state)]
    results[("forecast_mesh_failover", "mixed")] = dict(
        failovers=fos, lane_failures=st_["lane_failures"],
        bit_equal=len(same), requests=len(picks),
        reshard_ms=fo.get("reshard_ms"))
    moves = [(f["lost_device"], f["from_shape"], f["to_shape"],
              f["to_devices"]) for f in fos]
    say(f"forecast mesh kill (device_loss of logical device 3 from round 2, "
        f"fp32 and bf16 lanes): failovers (lost, from, to, to ids) {moves}, "
        f"reshard {fo.get('reshard_ms', float('nan')):.1f} ms (gather "
        f"every lane, compile on the survivors, shard); lane_failures "
        f"{st_['lane_failures']}; {len(same)} of {len(picks)} requests ok "
        f"and bit-equal to the fault-free drain [{card}]")
    check(len(fos) == 1 and fo.get("from_shape") == [2, 2]
          and fo.get("to_shape") == [2, 1] and fo.get("lost_device") == 3
          and 3 not in fo.get("to_devices", [3])
          and st_["lane_failures"] == 0 and len(same) == len(picks),
          "forecast mesh kill: not one (2, 2) -> (2, 1) failover with every "
          "request bit-equal")
    del eng, res
    torch.cuda.empty_cache()

    # ---- (d) wire corruption in shard 1 of a rolled-back slot --------------
    inj = FaultInjector([FaultSpec(kind="wire_corrupt", round=1, slot=0,
                                   shard=1)])
    eng = ForecastEngine(slots=slots, mesh=mesh, fault_injector=inj)
    work = [(request_state("float32", 1300 + i), n)
            for i, n in enumerate((2 * k, 2 * k - 1))]
    rids = [eng.submit(ForecastRequest(program=prog, state=s, steps=n))
            for s, n in work]
    res = eng.drain()
    st_ = eng.stats()
    other = res[rids[1]].status == "ok" and equal(
        res[rids[1]].state, solo(prog, *work[1], "single",
                                 pins["dycore float32"]))
    say(f"forecast mesh wire_corrupt (shard 1 of the rolled-back slot 0, "
        f"round 1): fingerprint_divergence {st_['fingerprint_divergence']}, "
        f"slot 0 {res[rids[0]].status} "
        f"({(res[rids[0]].diagnosis or {}).get('reason')}), the other slot "
        f"bit-equal to its solo run: {other}")
    check(st_["fingerprint_divergence"] >= 1 and st_["quarantined"] == 1
          and res[rids[0]].status == "failed" and other,
          "forecast mesh wire_corrupt: not caught, or the other slot moved")
    del eng, res

    # ---- (e) elastic restore: (2, 2) -> one device, (2, 2) -> (4, 1) -------
    d = ROOT / "build" / f"forecast-mesh-ckpt-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    work = [(request_state("float32", 1400 + i), int(n)) for i, n in
            enumerate(rng.integers(FORECAST_STEPS[0], FORECAST_STEPS[1] + 1,
                                   slots + 2))]
    eng = ForecastEngine(slots=slots, mesh=mesh, ckpt_dir=str(d))
    for s, n in work:
        eng.submit(ForecastRequest(program=prog, state=s, steps=n))
    eng.pump()
    eng.pump()
    step = eng.checkpoint()
    want = eng.drain()
    del eng
    for label, where in (("one device", {"device": dev}),
                         ("(4, 1)", {"mesh": make_mesh(
                             (4, 1), ("data", "model"), devices=[dev] * 4)})):
        t0 = time.perf_counter()
        back = ForecastEngine.restore(str(d), step, **where)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = back.drain()
        same = [rid for rid in want if rid in got and got[rid].status == "ok"
                and equal(got[rid].state, want[rid].state)]
        say(f"forecast mesh restore onto {label}: restored in "
            f"{restore_s:.3f} s (pins {list(back._pinned.values())}), "
            f"{len(same)} of {len(want)} results bit-equal to the "
            f"uninterrupted (2, 2) drain")
        check(len(same) == len(want) == len(got), f"forecast mesh restore "
              f"onto {label}: the resumed drain differs")
        del back, got
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return mix_launches


# ---------------------------------------------------------------------------
# phase 12 and --train-mesh: LM training on a torch.distributed device mesh
# ---------------------------------------------------------------------------

def train_plan(cfg) -> dict:
    """The flash, LRU and xent launches of one `remat="full"` training
    step of a decoder-only `cfg` (phase 7's plan)."""
    from repro_torch.models import lm

    kinds = lm.layer_kinds(cfg)
    period = len(cfg.pattern)
    recomputed = kinds[:cfg.n_repeats * period]
    attn = [k not in ("rec", "ssd") for k in kinds]
    return {"flash_attn": sum(attn) + sum(attn[:len(recomputed)]),
            "lru_scan": 2 * kinds.count("rec") + recomputed.count("rec"),
            "xent": 1}


def sp_rules(mesh, rows, seq_shard):
    """The caller's activation rules a mesh step keeps its `seq_shard`
    from (`train/loop.py`), as the dry-run sets them; none without
    `seq_shard`."""
    import contextlib

    from repro_torch.parallel import policy
    from repro_torch.parallel import sharding as shd

    if not seq_shard:
        return contextlib.nullcontext()
    return policy.activation_rules(shd.batch_sharding(mesh, rows), mesh,
                                   seq_shard=True)


def mesh_fit(torch, cfg, steps, mesh=None, profile=False, seq_shard=False):
    """`fit` over `cfg` at TRAIN_BATCH x TRAIN_SEQ from seed 0 with phase
    7's optimizer settings, on the card or on `mesh` (every rank alike;
    `seq_shard`: under the rules `sp_rules` sets): (params, history,
    launches, peak GB, rank 0's profiled extra step or None). The launch
    counts are reset just before the run and read just after."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.train import loop, optim

    model = api.build(cfg)
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=5,
                              total_steps=TRAIN_RUNS[0][2])
    data = synthetic.iterator(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                              device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with sp_rules(mesh, TRAIN_BATCH, seq_shard):
        params, opt_state, hist = loop.fit(model, data, steps=steps,
                                           opt_cfg=opt_cfg, remat="full",
                                           log_every=0, mesh=mesh)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in ("flash_attn", "lru_scan",
                                                 "xent")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = None
    if profile:              # one more step, profiled on rank 0 only
        import torch.distributed as dist

        step_fn, _ = loop.make_train_step(model, opt_cfg, remat="full",
                                          mesh=mesh)
        batch = next(data)

        def run():
            with sp_rules(mesh, TRAIN_BATCH, seq_shard):
                return step_fn(params, opt_state, batch)

        if dist.get_rank() == 0:
            prof = device_breakdown(run)
        else:
            run()
            torch.cuda.synchronize()
    del opt_state, data
    return params, hist, launches, peak, prof


def mesh_reduced_step(torch, arch, mesh, single_dev, seq_shard=False):
    """One fp32 AdamW step of `arch`'s reduced config on `mesh` (under
    `sp_rules`) against the same step on `single_dev` (the CPU, or this
    rank's card): the largest relative loss / grad-norm error and
    updated-parameter error."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.train import loop, optim

    cfg = dataclasses.replace(
        registry.reduced_config(registry.get_config(arch)),
        dtype="float32", param_dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic.lm_batch(cfg, 0, 0, 4, 33).items()}
    params = api.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    opt_cfg = optim.OptConfig(lr=1e-3)
    one = api.build(cfg, device=single_dev)
    p1 = copy.deepcopy(params).to(single_dev)
    p1, _, m1 = loop.make_train_step(one, opt_cfg, remat="full")(
        p1, optim.init_opt_state(p1),
        {k: v.to(single_dev) for k, v in batch.items()})
    step, _ = loop.make_train_step(api.build(cfg), opt_cfg, remat="full",
                                   mesh=mesh)
    p2 = copy.deepcopy(params).cuda()
    with sp_rules(mesh, 4, seq_shard):
        p2, _, m2 = step(p2, optim.init_opt_state(p2),
                         {k: v.cuda() for k, v in batch.items()})
    full = [p.full_tensor().detach().cpu() for p in p2.parameters()]
    err_m = max(abs(float(m2[k]) - float(m1[k])) / abs(float(m1[k]))
                for k in ("loss", "grad_norm"))
    err_p = max(float((a.detach().cpu() - b).abs().max())
                for a, b in zip(p1.parameters(), full))
    return err_m, err_p


def sp_bit_equal(torch, arch, mesh) -> bool:
    """One fp32 step of `arch`'s reduced config on `mesh` with and without
    `seq_shard` (`sp_rules`): metrics and updated parameters bit for
    bit (a model axis of 1 leaves nothing to shard)."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.train import loop, optim

    cfg = dataclasses.replace(
        registry.reduced_config(registry.get_config(arch)),
        dtype="float32", param_dtype="float32")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic.lm_batch(cfg, 0, 0, 4, 33).items()}
    model = api.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    runs = []
    for sp in (False, True):
        step, _ = loop.make_train_step(model, optim.OptConfig(lr=1e-3),
                                       remat="full", mesh=mesh)
        p = copy.deepcopy(params)
        with sp_rules(mesh, 4, sp):
            p, _, m = step(p, optim.init_opt_state(p), batch)
        runs.append(([float(v) for v in m.values()],
                     [x.full_tensor() for x in p.parameters()]))
    (m1, p1), (m2, p2) = runs
    return m1 == m2 and all(torch.equal(a, b) for a, b in zip(p1, p2))


def codec_checks(torch, dev, check, mesh, say_fn):
    """`parallel/compression.py` on the card: the int8 codec's error bound
    and unbiasedness (as the JAX package's tests hold them) and each
    `compressed_psum` method on `mesh`'s "data" axis."""
    from repro_torch.parallel import compression as comp

    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(256, 1024, generator=gen, device=dev)
    q, s = comp.int8_rowwise_encode(x, gen)
    err = (comp.int8_rowwise_decode(q, s) - x).abs()
    bound_ok = bool((err <= s + 1e-6).all())
    row = torch.linspace(-1, 1, 64, device=dev)[None] * 0.3712
    acc = torch.zeros_like(row, dtype=torch.float64)
    draws = 400
    for _ in range(draws):
        acc += comp.int8_rowwise_decode(
            *comp.int8_rowwise_encode(row, gen)).double()
    bias = float((acc / draws - row.double()).abs().max())
    say_fn(f"train mesh codec: int8 row-wise on the card, max err / scale "
           f"{float((err / s).max()):.4f} (bound 1), mean of {draws} "
           f"decodes off by {bias:.2e} (limit 5e-4)")
    check(bound_ok and bias <= 5e-4, "int8 codec: error bound or bias")
    tree = {"w": x, "b": x[0]}
    for method in comp.METHODS:
        out = comp.compressed_psum(tree, mesh, "data", method, generator=gen)
        n = mesh.size(0)
        errs = {k: float((out[k] - v).abs().max()) for k, v in tree.items()}
        lim = {"none": 1e-6, "bf16": 2 ** -8 * 4.5,
               "int8": float(s.max()) * 1.01}[method]
        say_fn(f"train mesh codec: compressed_psum {method} over data "
               f"({n} rank(s)): max err {max(errs.values()):.3g} "
               f"(limit {lim:.3g})")
        check(max(errs.values()) <= lim, f"compressed_psum {method}")
    ex = comp.exact_compressed_psum(tree, mesh, "data", generator=gen)
    e = max(float((ex[k] - v).abs().max()) for k, v in tree.items())
    check(e <= float(s.max()) * 1.01, "exact_compressed_psum")

# ---------------------------------------------------------------------------
# phase 13 and --train-mesh: the dry-run's trace held to the card's step
# ---------------------------------------------------------------------------

# rank 0's trace of training cells on a fake world (`launch/dryrun.py`);
# argv[1]: [[[arch, layers kept (0: all), seq_shard], ...], mesh shape,
# batch, seq]; a result a cell, keyed "arch" or "arch|sp"
DRYRUN_TRACE = r"""
import dataclasses, json, sys
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import hwspec
from repro_torch.launch import dryrun

cells, dims, batch, seq = json.loads(sys.argv[1])
mesh = dryrun.cell_mesh(tuple(dims), ("data", "model"))
out = {}
for arch, layers, sp in cells:
    cfg = registry.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    out[arch + ("|sp" if sp else "")] = dryrun.trace_cell(
        cfg, ShapeConfig("smoke", seq, batch, "train"), mesh, remat="full",
        spec=hwspec.load_spec("h100_sxm"), seq_shard=sp)
print(json.dumps(out))
"""
# the fake live peak's share of the card's peak that a traced cell must
# lie in (four measured cells read 0.838 to 0.999 on the H100)
DRYRUN_MEM_BAND = (0.75, 1.05)
# the launcher's variables a trace's process must not see (its fake world
# is its own)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "GROUP_RANK", "ROLE_RANK", "MASTER_ADDR", "MASTER_PORT",
              "TORCHELASTIC_RUN_ID")


def dryrun_traces(cells, dims):
    """Rank 0's trace of each (arch, layers, seq_shard) training cell at
    TRAIN_BATCH x TRAIN_SEQ, bf16, remat "full", on a fake world of
    prod(dims) ranks
    (`launch/dryrun.py::trace_cell` against the h100_sxm spec), in a
    subprocess that sees no card and no process group of this one:
    ({arch: result}, seconds)."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", DRYRUN_TRACE,
         json.dumps([cells, list(dims), TRAIN_BATCH, TRAIN_SEQ])],
        env=env, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SmokeFailure(f"the dry-run's trace failed:\n"
                           f"{res.stderr[-3000:]}")
    return (json.loads(res.stdout.strip().splitlines()[-1]),
            time.perf_counter() - t0)


def hold_dryrun(check, say_fn, label, r, per_step, step_ms, peak_gb,
                mfu=None) -> dict:
    """The gates of a traced cell against the card's run of it: each
    kernel's traced calls equal its launches in one step, the roofline
    bound is at or under the measured step (a bound above it would mean
    the counter over-counts), and the fake live peak lies within
    DRYRUN_MEM_BAND of the card's peak. The analytic estimate is printed
    beside them, not held: its model is the JAX package's, written for a
    TPU. Returns the line's numbers."""
    rf = r["roofline"]
    bound_ms = rf["step_time_bound_s"] * 1e3
    mem = r["memory"]
    out = dict(calls=r["kernel_calls"], launches_per_step=per_step,
               bound_ms=bound_ms, dominant=rf["dominant"],
               compute_ms=rf["compute_s"] * 1e3,
               memory_ms=rf["memory_s"] * 1e3,
               collective_ms=rf["collective_s"] * 1e3, step_ms=step_ms,
               bound_share=bound_ms / step_ms,
               roofline_fraction=rf["roofline_fraction"], mfu=mfu,
               analytic_gb=mem["analytic"]["total"] / 1e9,
               fake_live_gb=mem["fake_live_bytes_per_device"] / 1e9,
               peak_gb=peak_gb, live_share=0.0, flops=r["cost"]["flops"],
               bytes=r["cost"]["bytes accessed"],
               collectives=r["collectives"], trace_s=r["trace_s"],
               seq_shard=r.get("seq_shard", False))
    out["live_share"] = out["fake_live_gb"] / peak_gb
    lo, hi = DRYRUN_MEM_BAND
    say_fn(f"dryrun {label}: kernel calls traced {out['calls']}, launched "
           f"a step {per_step}; bound {bound_ms:.1f} ms ({rf['dominant']}: "
           f"compute {out['compute_ms']:.1f}, memory {out['memory_ms']:.1f},"
           f" collective {out['collective_ms']:.1f} ms; {out['flops']:.4g} "
           f"FLOPs, {out['bytes']:.4g} bytes, collectives "
           f"{out['collectives']}) against the measured step {step_ms:.1f} "
           f"ms ({out['bound_share']:.3f} of it); roofline_fraction "
           f"{out['roofline_fraction']:.4f}"
           + (f" beside the measured mfu {mfu:.4f}" if mfu is not None
              else "")
           + f"; memory a device: analytic estimate {out['analytic_gb']:.2f}"
           f" GB (printed, not held), fake live peak "
           f"{out['fake_live_gb']:.2f} GB, the card's peak {peak_gb:.2f} GB"
           f" ({out['live_share']:.3f} of it, band {lo}-{hi}); trace "
           f"{r['trace_s']:.1f} s")
    check(out["calls"] == per_step,
          f"dryrun {label}: traced calls {out['calls']}, launched a step "
          f"{per_step}")
    check(bound_ms <= step_ms,
          f"dryrun {label}: bound {bound_ms:.1f} ms above the measured "
          f"step {step_ms:.1f} ms")
    check(lo <= out["live_share"] <= hi,
          f"dryrun {label}: fake live peak {out['fake_live_gb']:.2f} GB is "
          f"{out['live_share']:.3f} of the card's {peak_gb:.2f} GB, outside "
          f"{lo}-{hi}")
    return out


def dryrun_phase(torch, check, results):
    """The dry-run against the card (phase 13): phase 7's training cells
    (tinyllama-1.1b in full, recurrentgemma-9b at full width and 3 layers,
    TRAIN_BATCH x TRAIN_SEQ, bf16, remat "full") traced at world 1 on a
    (1, 1) fake mesh, in a subprocess (phase 12 held a real process
    group), each held to phase 7's measured run (`hold_dryrun`)."""
    cells = [[arch, layers, False] for arch, layers, _ in TRAIN_RUNS]
    traced, secs = dryrun_traces(cells, (1, 1))
    say(f"dryrun: {len(cells)} cells traced at world 1 in {secs:.1f} s "
        f"(one subprocess, no card)")
    for arch, layers, steps in TRAIN_RUNS:
        m = results[(f"train_{arch}", "bfloat16")]
        per_step = {k: v // steps for k, v in m["launches"].items()}
        label = arch + (f" ({layers} layers)" if layers else "")
        results[(f"dryrun_{arch}", "bfloat16")] = hold_dryrun(
            check, say, label, traced[arch], per_step, m["step_ms"],
            m["peak_gb"], m["mfu"])


def train_mesh_phase(torch, dev, check, results):
    """LM training on a (1, 1) `DeviceMesh` on this card (phase 12): NCCL
    world of one, parameters, optimizer state and batches DTensors placed
    by the rule table. tinyllama-1.1b in full and recurrentgemma-9b at
    full width cut to phase 7's 3 layers, at TRAIN_BATCH x TRAIN_SEQ in
    bf16 through `fit(mesh=)` for TRAIN_MESH_STEPS steps with phase 7's
    seed and settings, each held to the same run on one device (losses,
    grad norms, parameters: bit for bit, else within 1e-5 relative) and
    to phase 7's own losses, with phase 7's launches a step (flash, LRU,
    xent through the DTensor seams); reduced fp32 mesh steps on the card
    against the CPU; the codec. Returns the mesh runs' launches by arch."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_device_mesh

    mesh = make_device_mesh((1, 1), ("data", "model"))
    say(f"train mesh: {mesh} on the card, backend {dist.get_backend()}, "
        f"world {dist.get_world_size()}")
    steps = TRAIN_MESH_STEPS
    launches = {}
    for arch, layers, _ in TRAIN_RUNS:
        full = registry.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers) if layers else full
        label = f"train mesh {arch}" + (f" ({layers} layers)" if layers
                                        else "")
        p1, h1, l1, peak1, _ = mesh_fit(torch, cfg, steps)
        p2, h2, l2, peak2, _ = mesh_fit(torch, cfg, steps, mesh=mesh)
        plan = train_plan(cfg)
        want = {k: v * steps for k, v in plan.items()}
        launches[arch] = l2
        say(f"{label}: launches {l2} over {steps} steps, one device "
            f"{l1}, planned {want} ({plan} a step, phase 7's)")
        check(l2 == want and l1 == want,
              f"{label}: launched {l2} (one device {l1}), planned {want}")
        rel = 0.0
        equal = True
        for a, b in zip(p1.parameters(), p2.parameters()):
            b = b.full_tensor()
            if not torch.equal(a, b):
                equal = False
                d = float((a.float() - b.float()).abs().max())
                rel = max(rel, d / max(float(a.float().abs().max()), 1e-30))
        keys = ("loss", "grad_norm")
        m_rel = max(abs(x[k] - y[k]) / abs(x[k])
                    for x, y in zip(h1, h2) for k in keys)
        p7 = results[(f"train_{arch}", cfg.dtype)]["losses"][:steps]
        say(f"{label}: losses mesh {[x['loss'] for x in h2]}, one device "
            f"{[x['loss'] for x in h1]}, phase 7 {p7}; grad norms mesh "
            f"{[x['grad_norm'] for x in h2]}; parameters bit-equal "
            f"{equal} (largest relative difference {rel:.3g}), metrics "
            f"relative difference {m_rel:.3g} (limit 1e-5)")
        check(m_rel <= 1e-5 and rel <= 1e-5,
              f"{label}: the (1, 1) mesh run is not the one-device run")
        check([x["loss"] for x in h1] == p7 or max(
            abs(a - b) / abs(b) for a, b in
            zip([x["loss"] for x in h1], p7)) <= 1e-5,
              f"{label}: one-device losses moved from phase 7's")
        ms1 = statistics.median(x["time_s"] for x in h1[1:]) * 1e3
        ms2 = statistics.median(x["time_s"] for x in h2[1:]) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        results[(f"train_mesh_{arch}", cfg.dtype)] = dict(
            mesh=[1, 1], steps=steps, losses=[x["loss"] for x in h2],
            step_ms=ms2, one_device_step_ms=ms1,
            step_ms_each=[x["time_s"] * 1e3 for x in h2],
            one_device_step_ms_each=[x["time_s"] * 1e3 for x in h1],
            overhead=ms2 / ms1 - 1.0, peak_gb=peak2, one_device_peak_gb=peak1,
            tokens_per_s=tokens / ms2 * 1e3, bit_equal=equal,
            param_rel=rel, launches=l2)
        say(f"{label}: step {ms2:.1f} ms on the (1, 1) mesh against "
            f"{ms1:.1f} ms on one device (median after the first; "
            f"DTensor overhead {100 * (ms2 / ms1 - 1):.2f}%), "
            f"{tokens / ms2 * 1e3:.0f} tokens/s, peak {peak2:.1f} GB "
            f"(one device {peak1:.1f} GB)")
        del p1, p2
        torch.cuda.empty_cache()
    for arch in ("tinyllama-1.1b", "recurrentgemma-9b",
                 "granite-moe-3b-a800m", "mamba2-1.3b", "whisper-medium"):
        err_m, err_p = mesh_reduced_step(torch, arch, mesh, "cpu")
        say(f"train mesh reduced {arch} fp32 step on the (1, 1) mesh: card "
            f"vs CPU loss/grad-norm relative err {err_m:.3g}, updated "
            f"params err {err_p:.3g} (limit 1e-4)")
        check(err_m <= 1e-4 and err_p <= 1e-4,
              f"train mesh reduced {arch}: the card disagrees with the CPU")
    for arch in ("tinyllama-1.1b", "granite-moe-3b-a800m"):
        same = sp_bit_equal(torch, arch, mesh)
        say(f"train mesh seq_shard {arch} reduced fp32 step on the (1, 1) "
            f"mesh: bit for bit the step without it {same}")
        check(same, f"train mesh seq_shard {arch}: the (1, 1) step moved")
    codec_checks(torch, dev, check, mesh, say)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


# the --train-mesh mode's meshes and runs (four cards, one process each)
MESH4_SHAPES = ((2, 2), (1, 4))
MESH4_REDUCED = {(2, 2): ("gemma3-27b", "granite-moe-3b-a800m",
                          "mamba2-1.3b", "moonshot-v1-16b-a3b", "olmo-1b",
                          "qwen2-vl-72b", "recurrentgemma-9b",
                          "tinyllama-1.1b", "whisper-medium", "yi-34b"),
                 (1, 4): ("tinyllama-1.1b", "recurrentgemma-9b",
                          "granite-moe-3b-a800m", "mamba2-1.3b",
                          "whisper-medium", "qwen2-vl-72b")}
MESH4_FULL = (("tinyllama-1.1b", 3), ("recurrentgemma-9b", 3))
# bf16 on four cards against one card, from the same seed and batch: the
# first loss (fp32 over every token; 2.87e-5 and 4.53e-5 relative measured
# on four H100s, PERF.md) and the first step's gradient norm, which one more
# bf16 rounding of every gradient element (2**-9 relative each) moves by
# at most 2**-9 relative
MESH4_LOSS_RTOL = 1e-3
MESH4_GNORM_RTOL = 2 ** -9
# `launch/train.py` on the ("pod", "data", "model") mesh beside (2, 2):
# the batch over (pod, data) and the gradients' sums over both must give
# the (2, 2) run's losses and grad norms (held at the limits above)
POD_MESHES = ("2,2", "2,1,2")
POD_ARCH, POD_STEPS = "tinyllama-1.1b", 3


def train_mesh_main() -> int:
    """`torchrun --nproc-per-node 4 chip_smoke.py --train-mesh`: LM
    training on four cards, one process each, over NCCL. The reduced
    families' fp32 steps on (2, 2) and (1, 4), each without and with
    `seq_shard`, against a one-card step; tinyllama-1.1b and
    recurrentgemma-9b at full width and depth (38 layers), bf16,
    TRAIN_BATCH x TRAIN_SEQ, remat="full", 3 steps on (2, 2) without and
    then with `seq_shard` (through `make_train_step(mesh=)` under
    `activation_rules(..., seq_shard=True)`, as the dry-run runs it), each
    first loss held to a forward-only `model.loss` on one card from the
    same seed and batch (MESH4_LOSS_RTOL) and its first gradient norm to
    one card's backward (MESH4_GNORM_RTOL), launches to `train_plan`, peak
    memory a card under 80 GB; step ms, tokens/s, mfu over the four cards
    and a profiled step's device idle share on rank 0, the `seq_shard`
    run's beside the same call's run without it. Then rank 0 traces the
    four cells on a (2, 2) fake world (`dryrun_traces`) and holds each
    trace to its rank's run (`hold_dryrun`: calls equal to launches a
    step, the bound at or under the measured step, the fake live peak
    within DRYRUN_MEM_BAND of the card's), the dry-run's
    roofline_fraction beside the measured mfu. Prints no result line;
    exits nonzero where a check failed on any rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.train import optim

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    meshes = {MESH4_SHAPES[0]: make_device_mesh(MESH4_SHAPES[0],
                                                ("data", "model"))}
    for shape in MESH4_SHAPES[1:]:
        meshes[shape] = init_device_mesh("cuda", shape,
                                          mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    say0 = say if rank == 0 else (lambda *_: None)
    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            say0(f"CHECK FAILED: {msg}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say0("train mesh cards: " + "; ".join(smi.stdout.strip().splitlines()))
    say0(f"train mesh: world {dist.get_world_size()}, backend "
         f"{dist.get_backend()}, torch {torch.__version__}")
    for shape, archs in MESH4_REDUCED.items():
        for arch in archs:
            for sp in (False, True):
                err_m, err_p = mesh_reduced_step(torch, arch, meshes[shape],
                                                 dev, seq_shard=sp)
                tag = " seq_shard" if sp else ""
                say0(f"train mesh reduced {arch} fp32{tag} step on {shape}: "
                     f"against one card loss/grad-norm relative err "
                     f"{err_m:.3g}, updated params err {err_p:.3g} (limits "
                     f"1e-5, 1e-4)")
                check(err_m <= 1e-5 and err_p <= 1e-4,
                      f"train mesh reduced {arch}{tag} {shape}")
    codec_checks(torch, dev, check, meshes[(2, 2)], say0)
    mesh = meshes[(2, 2)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    measured_idle = {}
    measured = {}
    for arch, steps in MESH4_FULL:
        cfg = registry.get_config(arch)
        want = want_norm = None
        if rank == 0:   # the loss, and the first gradient's norm, on one card
            model = api.build(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            batch = next(synthetic.iterator(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                            seed=0, device=dev))
            with torch.no_grad():
                want = float(model.loss(params, batch, remat="none"))
            params.requires_grad_(True)
            grads = torch.autograd.grad(
                model.loss(params, batch, remat="full"),
                list(params.parameters()))
            want_norm = float(optim.global_norm(grads))
            del model, params, batch, grads
            torch.cuda.empty_cache()
        for sp in (False, True):
            label = f"train mesh 4 cards {arch}" + (" seq_shard" if sp
                                                    else "")
            dist.barrier()
            params, hist, launches, peak, prof = mesh_fit(
                torch, cfg, steps, mesh=mesh, profile=True, seq_shard=sp)
            peaks = torch.tensor([peak], device=dev)
            dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
            losses = [x["loss"] for x in hist]
            step_s = statistics.median(x["time_s"] for x in hist[1:])
            mfu = 6 * cfg.param_count() * tokens / step_s / (
                4 * BF16_FLOPS_PER_S)
            plan = {k: v * steps for k, v in train_plan(cfg).items()}
            say0(f"{label}: {cfg.param_count() / 1e9:.3f} B parameters, "
                 f"{cfg.n_layers} layers, mesh (2, 2), batch {TRAIN_BATCH} "
                 f"x {TRAIN_SEQ}, bf16, remat full, {steps} steps; launches "
                 f"a rank {launches} (planned {plan})")
            check(launches == plan, f"{label}: launches {launches} != {plan}")
            if rank == 0:
                rel = abs(losses[0] - want) / abs(want)
                norm0 = hist[0]["grad_norm"]
                rel_norm = abs(norm0 - want_norm) / abs(want_norm)
                say0(f"{label}: losses {losses}, grad norms "
                     f"{[x['grad_norm'] for x in hist]}; first loss against "
                     f"one card's forward-only loss {want:.6f}: relative "
                     f"{rel:.3g} (limit {MESH4_LOSS_RTOL}); first grad norm "
                     f"against one card's backward {want_norm:.6f}: "
                     f"relative {rel_norm:.3g} (limit "
                     f"{MESH4_GNORM_RTOL:.3g})")
                check(rel <= MESH4_LOSS_RTOL, f"{label}: first loss")
                check(rel_norm <= MESH4_GNORM_RTOL,
                      f"{label}: first grad norm")
            check(all(x == x and abs(x) < 1e30 for x in losses),
                  f"{label}: non-finite loss")
            check(float(peaks) < 80.0, f"{label}: peak {float(peaks):.1f} GB")
            idle = prof["idle_share"] if prof else None
            measured[(arch, sp)] = (
                {k: v // steps for k, v in launches.items() if v},
                step_s * 1e3, float(peaks), mfu)
            beside = ""
            if sp:
                _, ms0, pk0, mfu0 = measured[(arch, False)]
                beside = (f"; without seq_shard in this call: step "
                          f"{ms0:.1f} ms, {tokens / ms0 * 1e3:.0f} tokens/s, "
                          f"mfu {mfu0:.4f}, peak {pk0:.1f} GB, idle share "
                          f"{measured_idle.get(arch)}")
            else:
                measured_idle[arch] = (None if idle is None
                                       else round(idle, 3))
            say0(f"{label}: step {step_s * 1e3:.1f} ms (median after the "
                 f"first; each {[round(x['time_s'] * 1e3, 1) for x in hist]}"
                 f"), {tokens / step_s:.0f} tokens/s, mfu {mfu:.4f} (6 x "
                 f"{cfg.param_count() / 1e9:.3f} B x {tokens} tokens over 4 "
                 f"x 989 TFLOP/s), peak {float(peaks):.1f} GB a card (max "
                 f"over ranks), rank 0's profiled step: "
                 + (f"host window {prof['wall_ms']:.1f} ms, device busy "
                    f"{prof['busy_ms']:.1f} ms, idle share {idle:.3f}, by "
                    f"kind " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        prof["by_category_ms"].items())
                    if prof else "no device kernel seen (not measured)")
                 + beside)
            del params
            torch.cuda.empty_cache()
    # the launcher on the pod mesh beside (2, 2), from the same seed
    from repro_torch.launch import train as launcher
    pod = {}
    for shape in POD_MESHES:
        dist.barrier()
        hist = launcher.main(
            ["--arch", POD_ARCH, "--steps", str(POD_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--mesh", shape])
        pod[shape] = ([x["loss"] for x in hist],
                      [x["grad_norm"] for x in hist],
                      [round(x["time_s"] * 1e3, 1) for x in hist])
        torch.cuda.empty_cache()
    (l2, g2, t2), (l3, g3, t3) = (pod[m] for m in POD_MESHES)
    say0(f"train mesh pod {POD_ARCH}: launch/train.py --mesh "
         f"{POD_MESHES[1]} (pod, data, model) against --mesh "
         f"{POD_MESHES[0]}, {POD_STEPS} steps at {TRAIN_BATCH} x "
         f"{TRAIN_SEQ}, bf16: losses {l3} against {l2}; grad norms {g3} "
         f"against {g2}; step ms {t3} against {t2}; losses bit-equal "
         f"{l3 == l2}, grad norms bit-equal {g3 == g2}")
    check(len(l3) == len(l2) == POD_STEPS, "train mesh pod: steps")
    check(all(abs(a - b) <= MESH4_LOSS_RTOL * abs(b) for a, b in zip(l3, l2))
          and all(abs(a - b) <= MESH4_GNORM_RTOL * abs(b)
                  for a, b in zip(g3, g2)),
          f"train mesh pod: (2, 1, 2) losses {l3} / grad norms {g3} against "
          f"(2, 2)'s {l2} / {g2}")
    if rank == 0:           # the dry-run of the cells against these runs
        cells = [[arch, 0, sp] for arch, _ in MESH4_FULL
                 for sp in (False, True)]
        traced, secs = dryrun_traces(cells, (2, 2))
        say0(f"train mesh dryrun: {len(cells)} cells traced as rank 0 of a "
             f"(2, 2) fake world in {secs:.1f} s (one subprocess, no card)")
        for arch, _, sp in cells:
            hold_dryrun(check, say0, f"4 cards (2, 2) {arch}"
                        + (" seq_shard" if sp else ""),
                        traced[arch + ("|sp" if sp else "")],
                        *measured[(arch, sp)])
    bad = torch.tensor([len(failures)], device=dev)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    dist.destroy_process_group()
    if int(bad):
        say0(f"train mesh: {int(bad)} check(s) failed on some rank")
        return 1
    say0("train mesh: all checks passed")
    return 0


# ---------------------------------------------------------------------------
# phase 14: the port's examples (`examples/torch_*.py`), each a subprocess
# ---------------------------------------------------------------------------

# the weather example at the main path's domain; train_lm's two runs
EXAMPLE_WEATHER = ["--grid", ",".join(map(str, GRID)), "--ensemble",
                   str(ENSEMBLE), "--steps", str(STEPS)]
# and again at 3x the steps: how much of a run's mean step is the
# process's first launches
EXAMPLE_WEATHER_LONG = EXAMPLE_WEATHER[:-1] + [str(3 * STEPS)]
# train_lm: the example's default run (its loss check compares the last
# step's loss with the first's; over 30 steps the two lie within a
# batch's spread, 9.844 -> 9.845 on the card), then 10 more steps resumed
# from its checkpoint
EXAMPLE_TRAIN_STEPS = (200, 210)
EXAMPLE_TIMEOUT_S = 600
# the kernel tests' fp32 tolerances the quickstart's errors are held to
EXAMPLE_TOL = {"hdiff": 1e-5, "vadvc": 2e-4}


def run_example(name: str, *args):
    """`examples/<name>.py *args` on the card in a subprocess: (exit code,
    stdout lines, host seconds, its `kernel launches` line as a dict,
    stderr's tail)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return None, [], time.perf_counter() - t0, {}, "timed out"
    secs = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    launches = {}
    for ln in lines:
        if ln.startswith("kernel launches: "):
            launches = json.loads(ln.split(": ", 1)[1])
    return res.returncode, lines, secs, launches, res.stderr[-2000:]


def examples_phase(check, results) -> dict:
    """Phase 14: each `examples/torch_*.py` on the card in a subprocess,
    exit 0 and its `OK` line required, its launches read from its own
    `kernel launches` line (a new process counts from 0): the quickstart
    (its kernel-vs-plain errors within EXAMPLE_TOL), the weather example
    at the main path's domain and ensemble on one device and on a (2, 2)
    mesh listing the card 4 times (equal final energies, one whole-state
    launch a step a shard), each for STEPS and 3 x STEPS steps, the
    forecast service plain, with `--chaos` (one quarantined request) and
    with `--kill-device 3` (every request bit for bit), LM training for EXAMPLE_TRAIN_STEPS[0] steps and its
    resume to EXAMPLE_TRAIN_STEPS[1] from the checkpoint, and LM serving.
    Returns the launches by kernel summed over the runs."""
    import shutil

    ckpt = ROOT / "build" / f"examples-train-lm-{os.getpid()}"
    runs = [("torch_quickstart", [], "quickstart OK"),
            ("torch_weather_simulation", EXAMPLE_WEATHER,
             "weather simulation OK"),
            ("torch_weather_simulation", EXAMPLE_WEATHER + ["--mesh", "2,2"],
             "weather simulation OK"),
            ("torch_weather_simulation", EXAMPLE_WEATHER_LONG,
             "weather simulation OK"),
            ("torch_weather_simulation",
             EXAMPLE_WEATHER_LONG + ["--mesh", "2,2"],
             "weather simulation OK"),
            ("torch_forecast_service", [], "forecast service OK"),
            ("torch_forecast_service", ["--chaos"], "forecast service OK"),
            ("torch_forecast_service", ["--kill-device", "3"],
             "mesh-failover drill OK")]
    runs += [("torch_train_lm", ["--steps", str(n), "--ckpt-dir", str(ckpt)],
              "train_lm OK") for n in EXAMPLE_TRAIN_STEPS]
    runs += [("torch_serve_lm", [], "serve_lm OK")]
    total, out = {}, {}
    try:
        for name, args, ok in runs:
            rc, lines, secs, launches, err = run_example(name, *args)
            label = " ".join([name] + args).replace(str(ROOT) + "/", "")
            good = rc == 0 and bool(lines) and lines[-1] == ok
            say(f"example {label}: exit {rc}, {secs:.1f} s on the host "
                f"clock, launches {launches}, last line "
                f"{lines[-1] if lines else None!r}")
            check(good, f"example {label}: exit {rc}, no {ok!r} line; "
                        f"stderr {err!r}")
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            out[label] = (lines, secs, launches)
            key = name + ("_mesh" if "--mesh" in args else "")
            results.setdefault(("example", key), {})[" ".join(args) or
                                                      "default"] = dict(
                seconds=secs, launches=launches, exit=rc)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    def lines_of(label):
        return out.get(label, ([], 0, {}))[0]

    def grab(label, prefix):
        return [ln for ln in lines_of(label) if ln.startswith(prefix)]

    # the quickstart: each kernel against its plain version
    for kernel, tol in EXAMPLE_TOL.items():
        got = grab("torch_quickstart", f"cuda {kernel} vs plain version: ")
        err = float(got[0].rsplit(" ", 1)[1]) if got else float("inf")
        say(f"example quickstart: {kernel} kernel vs plain version max err "
            f"{err:.3g} (limit {tol})")
        check(err <= tol, f"example quickstart: {kernel} err {err}")
    q = out.get("torch_quickstart", ([], 0, {}))[2]
    check(all(q.get(k, 0) > 0 for k in ("hdiff", "vadvc", "dycore_kstep",
                                         "hadv")),
          f"example quickstart: launches {q}")
    # the weather example: one device against the (2, 2) mesh
    single = " ".join(["torch_weather_simulation"] + EXAMPLE_WEATHER)
    mesh = single + " --mesh 2,2"
    long = " ".join(["torch_weather_simulation"] + EXAMPLE_WEATHER_LONG)
    for one, steps in ((single, STEPS), (long, 3 * STEPS)):
        e1 = grab(one, "final field energy")
        e2 = grab(one + " --mesh 2,2", "final field energy")
        say(f"example weather run({steps}): final energy one device {e1}, "
            f"(2, 2) mesh {e2}: equal {bool(e1) and e1 == e2}")
        check(bool(e1) and e1 == e2, f"example weather run({steps}): the "
                                     f"mesh run's final energy differs")
        check(bool(grab(one + " --mesh 2,2", "mesh (2, 2): 4 shards on 1 "
                                             "cuda")),
              "example weather: the mesh did not list the card 4 times")
        for label, want in ((one, steps), (one + " --mesh 2,2", 4 * steps)):
            n = out.get(label, ([], 0, {}))[2].get("dycore_fused")
            check(n == want, f"example {label}: {n} whole-state launches, "
                             f"want {want}")
    main = results.get(("main_step", "float32"), {}).get("ms")
    for label, label3, tag in ((single, long, "one device"),
                               (mesh, long + " --mesh 2,2", "(2, 2) mesh")):
        ms, ms3 = (grab(lb, f"{n} steps in ") for lb, n in
                   ((label, STEPS), (label3, 3 * STEPS)))
        ms, ms3 = (float(x[0].split(", ")[-1].split(" ms")[0]) if x else None
                   for x in (ms, ms3))
        results[("example", "torch_weather_simulation")][tag] = dict(
            step_ms=ms, step_ms_long=ms3, main_step_ms=main)
        say(f"example weather {tag}: {ms} ms a step over run({STEPS}), "
            f"{ms3} over run({3 * STEPS}) (host clock, from the process's "
            f"first launch); phase 4's main-path step {main} ms (median "
            f"of {REPS} calls)")
    # the forecast service: chaos and the failover drill
    chaos = grab("torch_forecast_service --chaos", "chaos: ")
    check(chaos == ["chaos: faults_fired=2 quarantined=1 round_retries=1 "
                    "failed=1"], f"example forecast --chaos: {chaos}")
    kill = grab("torch_forecast_service --kill-device 3", "bit for bit: ")
    say(f"example forecast --kill-device 3: {kill}")
    check(kill == ["bit for bit: 6 of 6 requests identical to their solo "
                   "runs on the original mesh"],
          f"example forecast --kill-device 3: {kill}")
    # LM training and its resume
    first, again = (" ".join(["torch_train_lm", "--steps", str(n),
                              "--ckpt-dir", str(ckpt)]).replace(
        str(ROOT) + "/", "") for n in EXAMPLE_TRAIN_STEPS)
    resumed = grab(again, "[fit] resuming from step ")
    check(resumed == [f"[fit] resuming from step {EXAMPLE_TRAIN_STEPS[0]}"],
          f"example train_lm: no resume ({resumed})")
    for label, steps in ((first, EXAMPLE_TRAIN_STEPS[0]),
                         (again, EXAMPLE_TRAIN_STEPS[1]
                          - EXAMPLE_TRAIN_STEPS[0])):
        n = out.get(label, ([], 0, {}))[2]
        check(n.get("xent") == steps and n.get("flash_attn", 0) > 0,
              f"example {label}: launches {n}, {steps} steps")
        say(f"example train_lm: "
            f"{grab(label, '[fit]') + grab(label, 'loss: ')}")
    s = out.get("torch_serve_lm", ([], 0, {}))[2]
    check(s.get("flash_attn", 0) > 0, f"example serve_lm: launches {s}")
    return total


def examples_main() -> int:
    """`python3 chip_smoke.py --examples`: phase 14 alone (the examples
    build the kernels at their first launch). Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    failures = []

    def check(ok, msg):
        if not ok:
            failures.append(msg)
            say(f"CHECK FAILED: {msg}")

    t0 = time.perf_counter()
    examples_phase(check, {})
    say(f"phase 14 (examples): {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    t_phase = [time.perf_counter()]

    def phase_done(label: str) -> None:
        """Print the seconds a phase took on the host's clock."""
        now = time.perf_counter()
        say(f"{label}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import autotune, hwspec, tiling
        from repro_torch.core.engine import NeroEngine
        from repro_torch.kernels import _build
        from repro_torch.kernels.copy_stencil import ref as copy_ref
        from repro_torch.kernels.copy_stencil.copy_stencil import copy_cuda
        from repro_torch.kernels.dycore_fused import ops as fused_ops
        from repro_torch.kernels.dycore_fused import ref as fused_ref
        from repro_torch.kernels.dycore_fused.fused import fused_dycore_cuda
        from repro_torch.kernels.dycore_fused.kstep import (
            fused_dycore_kstep_cuda)
        from repro_torch.kernels.hadv import ref as hadv_ref
        from repro_torch.kernels.hadv.hadv import hadv_cuda
        from repro_torch.kernels.hdiff import ref as hdiff_ref
        from repro_torch.kernels.hdiff.hdiff import (hdiff_cuda,
                                                     hdiff_kstep_cuda)
        from repro_torch.kernels.vadvc import ref as vadvc_ref
        from repro_torch.kernels.vadvc.vadvc import vadvc_cuda
        from repro_torch.weather import dycore, fields
        from repro_torch.weather.pipeline import (PipelineProgram,
                                                  PipelineStage)
        from repro_torch.weather.program import StencilProgram, compile
    except ImportError as e:
        raise SmokeFailure(f"the repro_torch package is not importable "
                           f"from {ROOT / 'src'}: {e}") from None
    dev = torch.device("cuda")
    # cuDNN would take float32 convolutions in TF32 (the hadv yardstick).
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    phase_done("phase 1 (the card)")

    # ---- 2. build -------------------------------------------------------
    _build.load()
    say(f"build: {_build.build_log['seconds']:.1f} s "
        f"({'built' if _build.build_log['built'] else 'cached'}) "
        f"-> {_build.build_log['path']}")
    for src, rep in _build.build_log["ptxas"].items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src}: {line.strip()}")
    # the bf16 route's kernels run on the tensor cores: the HGMMA
    # instructions (wgmma) cuobjdump finds in each one's instantiations
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    require(cuobjdump.exists(), f"{cuobjdump} not found")
    sass = subprocess.run([str(cuobjdump), "-sass", _build.build_log["path"]],
                          capture_output=True, text=True, timeout=300)
    require(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    hgmma, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            hgmma[fn] = 0
        elif fn and "HGMMA" in line:
            hgmma[fn] += 1
    for kern in ("flash_fwd_tc", "xent_partial_tc"):
        inst = {f: c for f, c in hgmma.items() if kern in f}
        say(f"sass: {kern}: {len(inst)} instantiations, HGMMA "
            f"instructions {sorted(inst.values())}")
        require(inst and min(inst.values()) > 0,
                f"{kern}: an instantiation issues no HGMMA")
    fp32_hgmma = sum(c for f, c in hgmma.items()
                     if "flash_fwd" in f and "flash_fwd_tc" not in f)
    say(f"sass: flash_fwd (fp32 route): {fp32_hgmma} HGMMA instructions")
    # the dycore kernels' registers and spill bytes: the k-step kernel's
    # register arrays must stay in registers, the whole-state kernel must
    # stay within the 32 registers its launch bounds give it
    for src, label in (("dycore_fused.cu", "fused"),
                       ("dycore_kstep.cu", "kstep"),
                       ("lru_scan.cu", "lru_scan"),
                       ("hdiff.cu", "hdiff"),
                       ("vadvc.cu", "vadvc"),
                       ("hadv.cu", "hadv")):
        rep = _build.build_log["ptxas"].get(src, "")
        entry, seen = None, 0
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif entry and ("registers" in line or "spill" in line):
                seen += 1
                say(f"{label} ptxas {entry}: "
                    f"{line.split(':', 1)[-1].strip()}")
        require(seen > 0, f"no ptxas report for {src}")
    for nf_ in (len(fields.PROGNOSTIC), 1):
        t = tiling.dycore_tile(GRID[1], GRID[2], nz=GRID[0], nf=nf_)
        say(f"fused tile nf={nf_}: {t.ty}x{t.tx} outputs, a block of "
            f"{t.threads} threads a tile and field, clusters of {t.cluster} "
            f"field blocks, {t.smem_bytes} bytes of shared memory a block")
    for k in KSTEPS:
        t = tiling.dycore_kstep_tile(GRID[1], GRID[2], k, nz=GRID[0])
        say(f"kstep tile k={k}: {t.ty}x{t.tx} outputs, cluster of "
            f"{t.cluster} blocks of {t.rows}x{t.tx + 4 * k} columns "
            f"({t.threads} threads), {t.smem_bytes} bytes of shared memory "
            f"a block")
    for k in (1,) + KSTEPS:
        n = GRID[1] + 4 * k
        t = tiling.hdiff_kstep_tile(n, n, k)
        say(f"hdiff tile k={k} at {n}x{n}: segments of {t.ty} rows, strips "
            f"of {t.tx} columns, {t.threads} threads a block, a ring of "
            f"{tiling.HDIFF_RING} rows, {t.smem_bytes} bytes of shared "
            f"memory a block")
    for dnz in (GRID[0], VADVC_DEPTHS[-1]):
        for isz in (4, 2):
            t = tiling.vadvc_tile(GRID[1], GRID[2], dnz, isz)
            say(f"vadvc tile nz={dnz} {8 * isz}-bit: a warp a block, "
                f"segments of {t.tx} columns, {t.smem_bytes} bytes of shared "
                f"memory a warp")
    for isz in (4, 2):
        for n in (GRID[1], GRID[1] + 1):
            t = tiling.hadv_tile(n, n, isz)
            say(f"hadv tile {n}x{n} {8 * isz}-bit: segments of {t.ty} rows, "
                f"strips of {t.tx} columns, {t.threads // 32} warps a block, "
                f"a ring of {tiling.HADV_RING} rows, {t.smem_bytes} bytes of "
                f"shared memory a block")

    nz, ny, nx = GRID
    nf = len(fields.PROGNOSTIC)
    vol = nz * ny * nx

    def make_state(dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        st = fields.initial_state(gen, GRID, ENSEMBLE, dtype=dtype,
                                  device=dev)
        extra = fields.initial_state(gen, GRID, ENSEMBLE, dtype=dtype,
                                     device=dev)
        st.stage_tens = extra.tens        # nonzero stage tendencies
        return st

    results = {}

    def fused_tile(ty, tx, nf_):
        """The whole-state kernel's ty x tx tile for nf_ fields, as
        `tiling.dycore_tile` builds it but without snapping ty."""
        cols = (ty + 4) * (tx + 4)
        return tiling.CudaTile("dycore_fused", ty, tx, cols, 8 * cols,
                               cluster=tiling.dycore_cluster(nf_))

    def hdiff_candidates(src, k):
        """The hdiff stream at k stages on each of `tiling.HDIFF_TILES`
        (the planner's candidates, unbalanced), queued,
        each bit for bit equal to the default tile's output."""
        _, Y, X = src.shape
        run = ((lambda t: hdiff_cuda(src, tile=t)) if k == 1 else
               (lambda t: hdiff_kstep_cuda(src, k_steps=k, tile=t)))
        want = run(None)
        cand = {}
        for cty, ctx in tiling.HDIFF_TILES:
            t = tiling.hdiff_kstep_tile(Y, X, k, ty=cty, tx=ctx)
            key = f"{t.ty}x{t.tx}"
            if key not in cand:
                check(torch.equal(run(t), want),
                      f"hdiff k={k} {src.dtype}: tile {key} differs")
                cand[key] = stream_ms(lambda: run(t))
        return cand

    def check_fused(label, fs, w, ts, ss, got_f, got_s, rtol):
        """Hold one fused step (got_f, got_s) against its plain version,
        computed in float32 from the same (possibly bf16) inputs and the
        same summed `w` the kernel takes. A bf16 kernel computes in fp32
        too and rounds each output once, so bf16 adds `rtol·|want|` to each
        point's fp32 limit. Returns the largest absolute error."""
        want_f, want_s = fused_ref.fused_step_ref_summed(
            fs.float(), w.float().unsqueeze(-4), ts.float(), ss.float())
        f2 = fs.float() + fused_ref.DEFAULT_DT * want_s
        fragile = fused_ref.limiter_fragile_mask(f2)
        flip = fused_ref.limiter_flip_bound(f2)
        df = (got_f.float() - want_f).abs()
        ds = (got_s.float() - want_s).abs()
        # Field: 1e-5 where no limiter branch is fragile; where one is, a
        # flip between the two operation orders may also keep or drop that
        # flux term, which moves the point by up to `flip`.
        xf = df - rtol * want_f.abs() - flip
        xs = ds - rtol * want_s.abs()
        field, stage = float(xf.max()), float(xs.max())
        # The stage is vadvc's output, in the Pallas kernel's operation
        # order on one side and the jnp oracle's on the other: vadvc's
        # tolerance applies to it.
        say(f"{label}: stage err {float(ds.max()):.3g} (atol 2e-4 + "
            f"{rtol:.3g}|want|, excess {stage:.3g}); field err "
            f"{float(df.max()):.3g} (atol 1e-5 + {rtol:.3g}|want| + flip "
            f"bound, excess {field:.3g}), "
            f"{float(torch.where(fragile, 0.0, df).max()):.3g} "
            f"off the {int(fragile.sum())} fragile points, largest flip "
            f"bound {float(flip.max()):.3g}")
        require(stage <= 2e-4 and field <= 1e-5,
                f"{label}: the fused step disagrees with its plain version")
        return max(float(df.max()), float(ds.max()))

    # Checks of the k-step slice are gathered, not raised one by one, so a
    # run that fails still reports every comparison; any failure fails the
    # run before the result line.
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            say(f"CHECK FAILED: {msg}")

    def spread(mask):
        """`mask` (..., nz, ny, nx) one step on: the whole column of each
        marked point (the Thomas solve couples the levels) and 2 points
        around it in y and x (hdiff's reach), periodic."""
        col = mask.any(dim=-3).float()
        lead = col.shape[:-2]
        col = torch.nn.functional.pad(col.reshape(-1, 1, ny, nx),
                                      (2, 2, 2, 2), mode="circular")
        col = torch.nn.functional.max_pool2d(col, 5, stride=1) > 0
        return col.reshape(*lead, 1, ny, nx).expand(mask.shape)

    def check_kstep_plain(label, fs, w, ts, ss, got_f, got_s, k, rtol):
        """Hold one k-step round (got_f, got_s) against its plain version,
        `fused_kstep_ref`, computed in float32 from the same (possibly
        bf16) inputs and the same summed `w`. A limiter branch that flips
        at one step moves its point, and in each later step reaches the
        whole column and 2 points further in y and x. So stage 2e-4 and
        field 1e-5 (plus rtol·|want|, one bf16 rounding) hold outside the
        plain trajectory's fragile points of every step, each spread so;
        every point holds LOOSE. Returns the largest absolute error."""
        args = [a.float() for a in (fs, w.unsqueeze(-4), ts, ss)]
        want_f, want_s = fused_ref.fused_kstep_ref(*args, k)
        f, wb, t, s = args
        near = torch.zeros(fs.shape, dtype=torch.bool, device=dev)
        for _ in range(k):
            f_prev = f
            f, s = fused_ref.fused_step_ref_summed(f, wb, t, s)
            near = spread(near) | fused_ref.limiter_fragile_mask(
                f_prev + fused_ref.DEFAULT_DT * s)
        require(torch.equal(f, want_f) and torch.equal(s, want_s),
                f"{label}: the plain trajectory differs from fused_kstep_ref")
        df = (got_f.float() - want_f).abs()
        ds = (got_s.float() - want_s).abs()
        xf = df - rtol * want_f.abs()
        xs = ds - rtol * want_s.abs()
        far = ~near
        field, stage = float(xf[far].max()), float(xs[far].max())
        every = max(float(xf.max()), float(xs.max()))
        say(f"{label}: vs fused_kstep_ref: field err {float(df.max()):.3g}, "
            f"stage err {float(ds.max()):.3g}; off the {int(near.sum())} "
            f"points near a fragile branch (of {near.numel()}): field "
            f"excess {field:.3g} (atol 1e-5 + {rtol:.3g}|want|), stage "
            f"excess {stage:.3g} (atol 2e-4); every point: excess {every:.3g} "
            f"(atol {LOOSE}), {int((xf > 1e-5).sum())} field points over "
            f"1e-5")
        check(field <= 1e-5 and stage <= 2e-4 and every <= LOOSE,
              f"{label}: the k-step round disagrees with fused_kstep_ref")
        return max(float(df.max()), float(ds.max()))

    phase_done("phase 2 (build)")

    # ---- 3. each kernel against its plain version on the card ----------
    # White noise at the main path's shapes, scaled as the JAX package's
    # kernel tests scale it (on smooth fields most points fall inside the
    # limiter-fragile mask, which would weaken the 1e-5 check). bf16 takes
    # the same noise rounded to bf16, and the plain version runs in fp32
    # from those bf16 values.
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = lambda scale, *shape: scale * torch.randn(
        shape, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        isz = torch.tensor([], dtype=dtype).element_size()
        rtol = 0.0 if dtype == torch.float32 else BF16_RTOL
        fs = noise(1.0, ENSEMBLE, nf, *GRID).to(dtype)   # (E, nf, nz, ny, nx)
        ts = noise(0.01, ENSEMBLE, nf, *GRID).to(dtype)
        ss = noise(0.01, ENSEMBLE, nf, *GRID).to(dtype)
        wcon = noise(0.15, ENSEMBLE, *GRID).to(dtype)
        w = fused_ops.staggered_w(wcon)

        # fused dycore, whole state, on the tile the planner picks for nf
        # fields (a cluster of the tile's field blocks shares w's sweep
        # coefficients); another tiling, and clusters of one (every block
        # its own coefficients), bit for bit
        tile_a = tiling.dycore_tile(ny, nx, nz=nz, nf=nf)
        tile_b = tiling.dycore_tile(ny, nx, ty=4, tx=64, nz=nz, nf=nf)
        tile_1 = tiling.dycore_tile(ny, nx, nz=nz)
        got_f, got_s = fused_dycore_cuda(fs, w, ts, ss, tile=tile_a)
        torch.cuda.synchronize()
        err = check_fused(f"fused {dn}", fs, w, ts, ss, got_f, got_s, rtol)
        for tile in (tile_b, tile_1):
            alt_f, alt_s = fused_dycore_cuda(fs, w, ts, ss, tile=tile)
            require(torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s),
                    f"fused dycore: tile {tile_a.ty}x{tile_a.tx} in clusters "
                    f"of {tile_a.cluster} and {tile.ty}x{tile.tx} in "
                    f"clusters of {tile.cluster} differ")
        ms = time_ms(lambda: fused_dycore_cuda(fs, w, ts, ss, tile=tile_a))
        queued_ms = stream_ms(lambda: fused_dycore_cuda(fs, w, ts, ss,
                                                        tile=tile_a))
        wb = w.unsqueeze(1)
        plain_ms = time_ms(lambda: fused_ref.fused_step_ref_summed(
            fs, wb, ts, ss))
        nbytes = (3 * ENSEMBLE * nf + ENSEMBLE + 2 * ENSEMBLE * nf) * vol * isz
        b_ms, b_by = bound(nbytes, 61.0 * ENSEMBLE * nf * vol)
        # the planner's tile beside the other candidates, queued, in
        # clusters of nf field blocks and of one
        cand = {}
        for cty, ctx in tiling.FUSED_TILES:
            for cnf in (nf, 1):
                t = fused_tile(cty, ctx, cnf)
                cand[f"{t.ty}x{t.tx} cluster {t.cluster}"] = stream_ms(
                    lambda: fused_dycore_cuda(fs, w, ts, ss, tile=t))
        results[("dycore_fused", dn)] = dict(
            err=err, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, tile=tile_a.describe(),
            tiles_queued_ms=cand)
        say(f"fused {dn}: {ms:.4f} ms, queued {queued_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); tiles and "
            f"cluster sizes bitwise equal; queued ms by tile: "
            + json.dumps(cand))
        # The per-field variant: the same kernel at nf = 1, one field, on
        # the planner's tile for one field; the field's slice of the
        # whole-state launch bit for bit.
        one = [a[:, 1:2].contiguous() for a in (fs, ts, ss)]
        tile_1 = tiling.dycore_tile(ny, nx, nz=nz, nf=1)
        one_f, one_s = fused_dycore_cuda(one[0], w, one[1], one[2],
                                         tile=tile_1)
        require(torch.equal(one_f, got_f[:, 1:2])
                and torch.equal(one_s, got_s[:, 1:2]),
                f"fused dycore {dn}: one field differs from its slice of the "
                f"whole-state launch")
        ms = time_ms(lambda: fused_dycore_cuda(one[0], w, one[1], one[2],
                                               tile=tile_1))
        queued_ms = stream_ms(lambda: fused_dycore_cuda(
            one[0], w, one[1], one[2], tile=tile_1))
        plain_ms = time_ms(lambda: fused_ref.fused_step_ref_summed(
            one[0], wb, one[1], one[2]))
        b_ms, b_by = bound(6 * ENSEMBLE * vol * isz, 61.0 * ENSEMBLE * vol)
        cand = {}
        for cty, ctx in tiling.FUSED_TILES:
            t = fused_tile(cty, ctx, 1)
            cand[f"{t.ty}x{t.tx}"] = stream_ms(
                lambda: fused_dycore_cuda(one[0], w, one[1], one[2], tile=t))
        results[("dycore_fused_per_field", dn)] = dict(
            ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, tile=tile_1.describe(), tiles_queued_ms=cand)
        say(f"fused per field {dn}: {ms:.4f} ms, queued {queued_ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); "
            f"equal to its slice of the whole state; queued ms by tile: "
            + json.dumps(cand))
        del one_f, one_s

        # Every depth runs the one build: nz from 2 to 1500 against the
        # plain version on ragged tiles of a smaller grid, in clusters of
        # the fields' blocks and in clusters of one, bit for bit.
        for dnz in DEPTHS:
            dgrid = (dnz, 37, 70)
            d_f, d_t, d_s = (noise(sc, 2, nf, *dgrid).to(dtype)
                             for sc in (1.0, 0.01, 0.01))
            d_w = fused_ops.staggered_w(noise(0.15, 2, *dgrid).to(dtype))
            tile = tiling.dycore_tile(37, 70, nz=dnz, nf=nf)
            d_gf, d_gs = fused_dycore_cuda(d_f, d_w, d_t, d_s, tile=tile)
            torch.cuda.synchronize()
            check_fused(f"fused {dn} nz={dnz} ({tile.ty}x{tile.tx} tile, "
                        f"clusters of {tile.cluster})", d_f, d_w, d_t, d_s,
                        d_gf, d_gs, rtol)
            alt_f, alt_s = fused_dycore_cuda(
                d_f, d_w, d_t, d_s, tile=tiling.dycore_tile(37, 70, nz=dnz))
            require(torch.equal(alt_f, d_gf) and torch.equal(alt_s, d_gs),
                    f"fused dycore {dn} nz={dnz}: clusters of {tile.cluster} "
                    f"and of one differ")
            del d_f, d_t, d_s, d_w, d_gf, d_gs
        del got_f, got_s, alt_f, alt_s, one, wb

        # hdiff on the wrap-padded stack
        src = fused_ref.pad_periodic(fs).reshape(-1, ny + 4, nx + 4)
        tile_a = tiling.hdiff_tile(ny + 4, nx + 4)
        tile_b = tiling.hdiff_tile(ny + 4, nx + 4, ty=16, tx=90)
        require(tile_b.tx != tile_a.tx, "hdiff: the second tiling's strips "
                "are the default's")
        got = hdiff_cuda(src, tile=tile_a)
        torch.cuda.synchronize()
        want = hdiff_ref.hdiff(src.float())
        d = (got.float() - want).abs()
        err, excess = float(d.max()), float((d - rtol * want.abs()).max())
        say(f"hdiff {dn} {tuple(src.shape)}: err {err:.3g}, excess "
            f"{excess:.3g} (atol 1e-5 + {rtol:.3g}|want|)")
        require(excess <= 1e-5, "hdiff kernel disagrees with its plain "
                "version")
        require(torch.equal(hdiff_cuda(src, tile=tile_b), got),
                "hdiff: two tilings differ")
        ms = time_ms(lambda: hdiff_cuda(src, tile=tile_a))
        queued_ms = stream_ms(lambda: hdiff_cuda(src, tile=tile_a))
        plain_ms = time_ms(lambda: hdiff_ref.hdiff(src))
        planes = src.shape[0]
        b_ms, b_by = bound(2 * src.numel() * isz,
                           21.0 * planes * (ny * nx))
        cand = hdiff_candidates(src, 1)
        results[("hdiff", dn)] = dict(err=err, ms=ms, queued_ms=queued_ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, tile=tile_a.describe(),
                                      tiles_queued_ms=cand)
        say(f"hdiff {dn}: {ms:.4f} ms, queued {queued_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); tiles "
            f"bitwise equal; queued ms by tile (segment x strip): "
            + json.dumps(cand))
        del src, got, want, d

        # vadvc on the field-stacked state, each member's wcon shared by
        # its fields, as the vadvc plan's whole-state step calls it (with
        # the state's periodic wcon); the staggered wcon, as the engine and
        # the parent take it, bit for bit; two tilings bit for bit
        wconp = torch.cat([wcon, wcon[..., :1]], dim=-1)
        tile_a = tiling.vadvc_tile(ny, nx, nz, isz)
        tile_b = tiling.vadvc_tile(ny, nx, nz, isz, cols=16)
        got = vadvc_cuda(fs, wcon, fs, ts, ss, tile=tile_a)
        torch.cuda.synchronize()
        want = vadvc_ref.vadvc(fs.float(), wconp.float().unsqueeze(1),
                               fs.float(), ts.float(), ss.float())
        d = (got.float() - want).abs()
        err, excess = float(d.max()), float((d - rtol * want.abs()).max())
        say(f"vadvc {dn} {tuple(fs.shape)}: err {err:.3g}, excess "
            f"{excess:.3g} (atol 2e-4 + {rtol:.3g}|want|)")
        require(excess <= 2e-4, "vadvc kernel disagrees with its plain "
                "version")
        require(torch.equal(vadvc_cuda(fs, wcon, fs, ts, ss, tile=tile_b),
                            got), "vadvc: two tilings differ")
        require(torch.equal(vadvc_cuda(fs, wconp, fs, ts, ss, tile=tile_a),
                            got), "vadvc: the periodic and the staggered "
                "wcon differ")
        ms = time_ms(lambda: vadvc_cuda(fs, wcon, fs, ts, ss, tile=tile_a))
        queued_ms = stream_ms(lambda: vadvc_cuda(fs, wcon, fs, ts, ss,
                                                 tile=tile_a))
        stag_ms = time_ms(lambda: vadvc_cuda(fs, wconp, fs, ts, ss,
                                             tile=tile_a))
        stag_queued_ms = stream_ms(lambda: vadvc_cuda(fs, wconp, fs, ts, ss,
                                                      tile=tile_a))
        wpb = wcon.unsqueeze(1)
        plain_ms = time_ms(lambda: vadvc_ref.vadvc(fs, wpb, fs, ts, ss))
        # three fields read (u_pos is u_stage), one written, and each
        # member's periodic wcon read once
        nbytes = (4 * fs.numel() + wcon.numel()) * isz
        b_ms, b_by = bound(nbytes, 38.0 * fs.numel())
        results[("vadvc", dn)] = dict(err=err, ms=ms, queued_ms=queued_ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by,
                                      staggered_ms=stag_ms,
                                      staggered_queued_ms=stag_queued_ms,
                                      tile=tile_a.describe())
        say(f"vadvc {dn}: {ms:.4f} ms, queued {queued_ms:.4f} ms; staggered "
            f"wcon {stag_ms:.4f} ms, queued {stag_queued_ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); tiles and "
            f"wcon forms bitwise equal")
        del wconp, wpb, got, want, d
        # Every depth runs the one build: nz from 2 to 1500 (fewer columns
        # a warp) on a ragged (37, 70) plane, u_pos apart from u_stage,
        # against the plain version; a second tiling bit for bit.
        for dnz in VADVC_DEPTHS:
            dgrid = (dnz, 37, 70)
            d_u, d_p, d_t, d_s = (noise(sc, 2, 3, *dgrid).to(dtype)
                                  for sc in (1.0, 1.0, 0.01, 0.01))
            d_w = noise(0.15, 2, *dgrid).to(dtype)
            tile = tiling.vadvc_tile(37, 70, dnz, isz)
            d_g = vadvc_cuda(d_u, d_w, d_p, d_t, d_s, tile=tile)
            torch.cuda.synchronize()
            want = vadvc_ref.vadvc(*(a.float() for a in (
                d_u, d_w.unsqueeze(1), d_p, d_t, d_s)))
            d = (d_g.float() - want).abs()
            excess = float((d - rtol * want.abs()).max())
            say(f"vadvc {dn} nz={dnz} ({tile.tx} columns a warp, "
                f"{tile.smem_bytes} bytes of shared memory): err "
                f"{float(d.max()):.3g}, excess {excess:.3g}")
            require(excess <= 2e-4, f"vadvc {dn} nz={dnz}: disagrees with "
                    f"its plain version")
            require(torch.equal(vadvc_cuda(
                d_u, d_w, d_p, d_t, d_s,
                tile=tiling.vadvc_tile(37, 70, dnz, isz, cols=5)), d_g),
                f"vadvc {dn} nz={dnz}: two tilings differ")
            del d_u, d_p, d_t, d_s, d_w, d_g, want, d

        # dycore k-step rounds. float32: k chained whole-state launches,
        # each held against its plain version from the same input, and the
        # k-step round equal to the chain bit for bit. bf16: the kernel
        # computes in fp32 and rounds once, so it is the float32 kernel on
        # the same values upcast, rounded once, bit for bit. `wcon` is
        # scaled down to 0.05 here: at 0.15 the Thomas diagonal
        # 0.15 + 0.125·(w_k − w_{k+1}) crosses zero in some columns of this
        # grid, the stage grows step by step there, and after one step the
        # two operation orders part by 0.15 (H100 run), so a comparison past
        # step 1 would test the conditioning, not the kernel. At 0.05 the
        # diagonal stays above 0.08.
        w = fused_ops.staggered_w(noise(0.05, ENSEMBLE, *GRID).to(dtype))
        wb = w.unsqueeze(1)
        for k in KSTEPS:
            name = "dycore_kstep" + ("" if k == KSTEPS[0] else f"_k{k}")
            # the default tile and the other k's default, both timed
            tile_a = tiling.dycore_kstep_tile(ny, nx, k)
            tile_b = tiling.dycore_kstep_tile(
                ny, nx, k, *tiling.dycore_kstep_default(3 if k <= 2 else 2))
            got_f, got_s = fused_dycore_kstep_cuda(fs, w, ts, ss, k_steps=k,
                                                   tile=tile_a)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                cf, cs = fs, ss
                for i in range(k):
                    nf_, ns_ = fused_dycore_cuda(cf, w, ts, cs)
                    check_fused(f"dycore k={k} chain step {i + 1}", cf, w, ts,
                                cs, nf_, ns_, 0.0)
                    cf, cs = nf_, ns_
                check(torch.equal(got_f, cf) and torch.equal(got_s, cs),
                      f"dycore k-step k={k}: differs from {k} whole-state "
                      f"launches")
                del cf, cs, nf_, ns_
            else:
                up_f, up_s = fused_dycore_kstep_cuda(
                    fs.float(), w.float(), ts.float(), ss.float(), k_steps=k,
                    tile=tile_a)
                check(torch.equal(got_f, up_f.to(dtype))
                      and torch.equal(got_s, up_s.to(dtype)),
                      f"dycore k-step k={k} bf16: differs from the float32 "
                      f"kernel on the same values rounded once")
                del up_f, up_s
            err = check_kstep_plain(f"dycore k-step {dn} k={k}", fs, w, ts,
                                    ss, got_f, got_s, k, rtol)
            alt_f, alt_s = fused_dycore_kstep_cuda(fs, w, ts, ss, k_steps=k,
                                                   tile=tile_b)
            check(torch.equal(alt_f, got_f) and torch.equal(alt_s, got_s),
                  f"dycore k-step k={k}: tiles {tile_a.ty}x{tile_a.tx} and "
                  f"{tile_b.ty}x{tile_b.tx} differ")
            del got_f, got_s, alt_f, alt_s
            ms = time_ms(lambda: fused_dycore_kstep_cuda(
                fs, w, ts, ss, k_steps=k, tile=tile_a))
            queued_ms = stream_ms(lambda: fused_dycore_kstep_cuda(
                fs, w, ts, ss, k_steps=k, tile=tile_a), n=20)
            ms_b = time_ms(lambda: fused_dycore_kstep_cuda(
                fs, w, ts, ss, k_steps=k, tile=tile_b))

            def chain():
                cf, cs = fs, ss
                for _ in range(k):
                    cf, cs = fused_dycore_cuda(cf, w, ts, cs)
            chain_ms = time_ms(chain)
            chain_queued_ms = stream_ms(chain, n=20)
            plain_ms = time_ms(lambda: fused_ref.fused_kstep_ref(
                fs, wb, ts, ss, k))
            # The round moves the bytes of one whole-state step and does the
            # operations of k.
            nbytes = (3 * ENSEMBLE * nf + ENSEMBLE + 2 * ENSEMBLE * nf) * vol \
                * isz
            b_ms, b_by = bound(nbytes, 61.0 * k * ENSEMBLE * nf * vol)
            results[(name, dn)] = dict(
                err=err, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, k=k, per_step_ms=ms / k,
                whole_state_launches_ms=chain_ms,
                whole_state_launches_queued_ms=chain_queued_ms,
                tile=tile_a.describe(), other_tile=tile_b.describe(),
                other_tile_ms=ms_b)
            say(f"dycore k-step {dn} k={k}: {ms:.4f} ms a round, queued "
                f"{queued_ms:.4f} ms, {ms / k:.4f} ms a step; {k} whole-state "
                f"launches {chain_ms:.4f} ms, queued {chain_queued_ms:.4f} ms "
                f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); "
                f"tiles {tile_a.ty}x{tile_a.tx} and {tile_b.ty}x{tile_b.tx} "
                f"bitwise equal, the second {ms_b:.4f} ms")
            torch.cuda.empty_cache()
        del wb

        # hdiff k-step rounds on the 2k-wrap-padded stack the hdiff k-step
        # plan gives the kernel: k launches of the one-step kernel, bit for
        # bit (every step rounds through the storage dtype), and the plain
        # version, which rounds so too.
        for k in KSTEPS:
            name = "hdiff_kstep" + ("" if k == KSTEPS[0] else f"_k{k}")
            src = fused_ref.pad_periodic(fs, 2 * k).reshape(
                -1, ny + 4 * k, nx + 4 * k)
            planes, Y, X = src.shape
            tile_a = tiling.hdiff_kstep_tile(Y, X, k)
            tile_b = tiling.hdiff_kstep_tile(Y, X, k, ty=16, tx=90)
            check(tile_b.tx != tile_a.tx, f"hdiff k-step k={k}: the second "
                  f"tiling's strips are the default's")
            got = hdiff_kstep_cuda(src, k_steps=k, tile=tile_a)
            chain = src
            for _ in range(k):
                chain = hdiff_cuda(chain)
            torch.cuda.synchronize()
            check(torch.equal(got, chain), f"hdiff k-step {dn} k={k}: "
                  f"differs from {k} hdiff launches")
            want = hdiff_ref.hdiff_kstep(src, k=k).float()
            d = (got.float() - want).abs()
            err, excess = float(d.max()), float((d - rtol * want.abs()).max())
            say(f"hdiff k-step {dn} k={k} {tuple(src.shape)}: err {err:.3g}, "
                f"excess {excess:.3g} (atol 1e-5 + {rtol:.3g}|want|)")
            check(excess <= 1e-5, f"hdiff k-step {dn} k={k}: disagrees with "
                  f"its plain version")
            check(torch.equal(hdiff_kstep_cuda(src, k_steps=k, tile=tile_b),
                              got), f"hdiff k-step {dn} k={k}: two tilings "
                  f"differ")
            del got, chain, want, d
            ms = time_ms(lambda: hdiff_kstep_cuda(src, k_steps=k,
                                                  tile=tile_a))
            queued_ms = stream_ms(lambda: hdiff_kstep_cuda(src, k_steps=k,
                                                           tile=tile_a))

            def chain():
                c = src
                for _ in range(k):
                    c = hdiff_cuda(c)
            chain_ms = time_ms(chain)
            chain_queued_ms = stream_ms(chain)
            plain_ms = time_ms(lambda: hdiff_ref.hdiff_kstep(src, k=k))
            b_ms, b_by = bound(2 * src.numel() * isz,
                               21.0 * k * planes * (Y - 4) * (X - 4))
            cand = hdiff_candidates(src, k)
            results[(name, dn)] = dict(
                err=err, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, hdiff_launches_ms=chain_ms,
                hdiff_launches_queued_ms=chain_queued_ms,
                tile=tile_a.describe(), tiles_queued_ms=cand)
            say(f"hdiff k-step {dn} k={k}: {ms:.4f} ms, queued "
                f"{queued_ms:.4f} ms; {k} hdiff launches {chain_ms:.4f} ms, "
                f"queued {chain_queued_ms:.4f} ms (plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms by {b_by}); tiles bitwise equal; "
                f"queued ms by tile (segment x strip): "
                + json.dumps(cand))
            del src

        # longer hdiff rounds: k launches of the one-step kernel, bit for
        # bit, and the plain version
        for k in LONG_KSTEPS:
            src = fused_ref.pad_periodic(fs, 2 * k).reshape(
                -1, ny + 4 * k, nx + 4 * k)
            before = _build.LAUNCHES["hdiff_kstep"]
            got = hdiff_kstep_cuda(src, k_steps=k)
            launches = _build.LAUNCHES["hdiff_kstep"] - before
            check(launches == len(tiling.hdiff_launches(k)),
                  f"hdiff k-step {dn} k={k}: {launches} launches")

            def chain():
                c = src
                for _ in range(k):
                    c = hdiff_cuda(c)
                return c
            check(torch.equal(got, chain()), f"hdiff k-step {dn} k={k}: "
                  f"differs from {k} hdiff launches")
            want = hdiff_ref.hdiff_kstep(src, k=k).float()
            d = (got.float() - want).abs()
            err, excess = float(d.max()), float((d - rtol * want.abs()).max())
            check(excess <= 1e-5, f"hdiff k-step {dn} k={k}: disagrees with "
                  f"its plain version")
            del got, want, d
            ms = time_ms(lambda: hdiff_kstep_cuda(src, k_steps=k))
            queued_ms = stream_ms(lambda: hdiff_kstep_cuda(src, k_steps=k))
            chain_ms, chain_queued_ms = time_ms(chain), stream_ms(chain)
            say(f"hdiff k-step {dn} k={k} {tuple(src.shape)}: {launches} "
                f"launch(es), err {err:.3g}, excess {excess:.3g}; {ms:.4f} "
                f"ms, queued {queued_ms:.4f} ms; {k} hdiff launches "
                f"{chain_ms:.4f} ms, queued {chain_queued_ms:.4f} ms; equal "
                f"to them bit for bit")
            del src

        # hadv, periodic, on the field-stacked state as the hadv_upwind
        # plan gives it (unpadded): bit for bit the passthrough mode on the
        # stack wrap-padded by 1 on the low sides, cropped (the parent's
        # plan); each mode against its plain version; two tilings that
        # differ in strip width and segment height bit for bit.
        cfl = fused_ref.DEFAULT_COEFF          # the program's coeff is its cfl
        src = fs.reshape(-1, ny, nx)
        pad = torch.cat([fs[..., -1:, :], fs], dim=-2)
        pad = torch.cat([pad[..., :, -1:], pad], dim=-1).reshape(
            -1, ny + 1, nx + 1)
        planes, Y, X = pad.shape
        checks = {}
        for mode, x, plain in (
                ("periodic", src, hadv_ref.hadv_periodic),
                ("passthrough", pad, hadv_ref.hadv_upwind)):
            periodic = mode == "periodic"
            tile_a = tiling.hadv_tile(*x.shape[1:], isz)
            tile_b = tiling.hadv_tile(*x.shape[1:], isz, ty=13,
                                      tx=x.shape[2] // 3)
            got = hadv_cuda(x, cfl=cfl, tile=tile_a, periodic=periodic)
            torch.cuda.synchronize()
            want = plain(x.float(), cfl=cfl)
            d = (got.float() - want).abs()
            err, excess = float(d.max()), float((d - rtol * want.abs()).max())
            say(f"hadv {mode} {dn} {tuple(x.shape)}: err {err:.3g}, excess "
                f"{excess:.3g} (atol 1e-5 + {rtol:.3g}|want|); strips of "
                f"{tile_a.tx} and {tile_b.tx}, segments of {tile_a.ty} and "
                f"{tile_b.ty}")
            check(excess <= 1e-5, f"hadv {mode} {dn}: disagrees with its "
                  f"plain version")
            check(torch.equal(hadv_cuda(x, cfl=cfl, tile=tile_b,
                                        periodic=periodic), got),
                  f"hadv {mode} {dn}: two tilings differ")
            checks[mode] = (err, got, tile_a)
        check(torch.equal(checks["periodic"][1],
                          checks["passthrough"][1][:, 1:, 1:]),
              f"hadv {dn}: periodic differs from pad + passthrough + crop")
        del got, want, d
        err, _, tile_a = checks["periodic"]
        ms = time_ms(lambda: hadv_cuda(src, cfl=cfl, tile=tile_a,
                                       periodic=True))
        queued_ms = stream_ms(lambda: hadv_cuda(src, cfl=cfl, tile=tile_a,
                                                periodic=True))
        plain_ms = time_ms(lambda: hadv_ref.hadv_periodic(src, cfl=cfl))
        pt_tile = checks["passthrough"][2]
        pt_ms = time_ms(lambda: hadv_cuda(pad, cfl=cfl, tile=pt_tile))
        pt_queued_ms = stream_ms(lambda: hadv_cuda(pad, cfl=cfl,
                                                   tile=pt_tile))
        del checks
        # One convolution computes the same points from the padded stack:
        # the yardstick, never called by the port.
        weight = torch.tensor([[0.0, cfl], [cfl, 1.0 - 2.0 * cfl]],
                              dtype=dtype, device=dev).reshape(1, 1, 2, 2)
        planes4 = pad.reshape(planes, 1, Y, X)
        library_ms = time_ms(lambda: torch.nn.functional.conv2d(planes4,
                                                                weight))
        b_ms, b_by = bound(2 * src.numel() * isz, 5.0 * src.numel())
        results[("hadv", dn)] = dict(err=err, ms=ms, queued_ms=queued_ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=library_ms,
                                     passthrough_ms=pt_ms,
                                     passthrough_queued_ms=pt_queued_ms,
                                     tile=tile_a.describe())
        say(f"hadv periodic {dn}: {ms:.4f} ms, queued {queued_ms:.4f} ms; "
            f"passthrough {tuple(pad.shape)} {pt_ms:.4f} ms, queued "
            f"{pt_queued_ms:.4f} ms (plain {plain_ms:.3f} ms, conv2d "
            f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}); tiles "
            f"bitwise equal")
        del src, pad, planes4, fs, ts, ss, wcon, w
        torch.cuda.empty_cache()

    phase_done("phase 3 (kernel checks)")

    # ---- 4. the main path and the per-kernel plans ----------------------
    def energy(st):
        return float(sum(float(f.float().square().sum())
                         for f in st.fields.values()))

    def stacked(st, part):
        return dycore.stack_state(getattr(st, part))

    def launches_of(**nonzero):
        """A full launch count: the named kernels as given, every other 0."""
        return {k: nonzero.get(k, 0) for k in _build.LAUNCHES}

    main_launches = {}
    for dtype in ("float32", "bfloat16"):
        st = make_state(dtype, seed=2)
        rtol = 0.0 if dtype == "float32" else BF16_RTOL
        prog = StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                              dtype=dtype)
        plan = compile(prog)
        require(plan.variant == "whole_state" and plan.k_steps == 1,
                f"main path resolved to {plan.variant}/k={plan.k_steps}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _build.reset_launches()
        out = plan.run(st, STEPS)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        run_peak = torch.cuda.max_memory_allocated() - resident
        expect = STEPS * plan.pallas_calls_per_round
        say(f"main path {dtype}: launches {counts} (expect dycore_fused = "
            f"{expect})")
        require(counts == launches_of(dycore_fused=expect),
                "the main path did not run exactly one fused launch per "
                "step")
        if dtype == "float32":
            main_launches["dycore_fused"] = counts["dycore_fused"]
        for n in out.fields:
            require(tuple(out.fields[n].shape) == (ENSEMBLE,) + GRID,
                    f"field {n} has shape {tuple(out.fields[n].shape)}")
            require(bool(torch.isfinite(out.fields[n]).all()
                         and torch.isfinite(out.stage_tens[n]).all()),
                    f"field {n} is not finite after {STEPS} steps")
        # Every step against the plain version from the same input, so a
        # flipped limiter branch cannot spread into the next comparison;
        # then `run` must equal the repeated steps bit for bit.
        cur = st
        for i in range(STEPS):
            nxt = plan.step(cur)
            check_fused(f"main path {dtype} step {i + 1}",
                        stacked(cur, "fields"),
                        fused_ops.staggered_w(cur.wcon), stacked(cur, "tens"),
                        stacked(cur, "stage_tens"), stacked(nxt, "fields"),
                        stacked(nxt, "stage_tens"), rtol)
            cur = nxt
        require(all(torch.equal(cur.fields[n], out.fields[n])
                    and torch.equal(cur.stage_tens[n], out.stage_tens[n])
                    for n in out.fields),
                f"main path {dtype}: run({STEPS}) differs from {STEPS} "
                f"steps")
        oracle = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                        dtype=dtype, variant="unfused")
                         ).run(st, STEPS)
        err = max(max_err(out.fields[n], oracle.fields[n])
                  for n in out.fields)
        err_s = max(max_err(out.stage_tens[n], oracle.stage_tens[n])
                    for n in out.fields)
        # Limiter branches that flip between the fused and unfused orders
        # (measure-zero points, `limiter_fragile_mask`) move a point by at
        # most LOOSE per step and diffuse afterwards; in bf16 the unfused
        # plan also rounds the stage and the updated field to bf16 inside
        # each step where the kernel keeps fp32, hence 0.25, the JAX
        # package's bf16 tolerance.
        tol = LOOSE if dtype == "float32" else 0.25
        say(f"main path {dtype}: {STEPS} steps vs unfused plan: field err "
            f"{err:.3g}, stage err {err_s:.3g} (atol {tol}); energy "
            f"{energy(st):.6g} -> {energy(out):.6g}")
        require(err <= tol and err_s <= tol,
                "the main path disagrees with the unfused plan")
        step_ms = time_ms(lambda: plan.step(st))
        results[("main_step", dtype)] = dict(ms=step_ms,
                                             run_peak_bytes=run_peak)
        say(f"main path {dtype}: one step {step_ms:.4f} ms; run({STEPS}) "
            f"peaked {run_peak / 1e6:.1f} MB of device memory above the "
            f"{resident / 1e6:.1f} MB resident before it (tile "
            f"{plan.tile.ty}x{plan.tile.tx}, clusters of {plan.tile.cluster} "
            f"field blocks)")
        del st, out, oracle, cur, nxt
        torch.cuda.empty_cache()

    # Every kernelled variant of every op, one step each from one state:
    # launches counted, per_field bit-equal to whole_state, whole_state
    # held against the plain version.
    st = make_state("float32", seed=3)
    for op, kernel in (("dycore", "dycore_fused"), ("hdiff", "hdiff"),
                       ("vadvc", "vadvc")):
        outs = {}
        for variant in ("whole_state", "per_field"):
            plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                          op=op, variant=variant))
            _build.reset_launches()
            outs[variant] = plan.run(st, 1)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            say(f"op={op} {variant}: launches {counts} (expect {kernel} = "
                f"{plan.pallas_calls_per_round})")
            require(counts[kernel] == plan.pallas_calls_per_round
                    == sum(counts.values()),
                    f"op={op} {variant} plan launched {counts}")
            if op != "dycore" and variant == "whole_state":
                main_launches[kernel] = counts[kernel]
        ws, pf = outs["whole_state"], outs["per_field"]
        require(all(torch.equal(ws.fields[n], pf.fields[n])
                    and torch.equal(ws.stage_tens[n], pf.stage_tens[n])
                    for n in ws.fields),
                f"op={op}: per_field differs from whole_state")
        if op == "dycore":
            check_fused("op=dycore whole_state", stacked(st, "fields"),
                        fused_ops.staggered_w(st.wcon), stacked(st, "tens"),
                        stacked(st, "stage_tens"), stacked(ws, "fields"),
                        stacked(ws, "stage_tens"), 0.0)
            continue
        tol = {"hdiff": 1e-5, "vadvc": 2e-4}[op]
        oracle = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                        op=op, variant="unfused")).run(st, 1)
        err = max(max_err(getattr(ws, part)[n], getattr(oracle, part)[n])
                  for part in ("fields", "stage_tens") for n in ws.fields)
        say(f"op={op}: per_field == whole_state bit for bit; vs unfused "
            f"plan err {err:.3g} (atol {tol})")
        require(err <= tol, f"op={op} plan disagrees with its unfused plan")
        if op == "hdiff":
            e0, e1 = energy(st), energy(ws)
            say(f"op=hdiff: energy {e0:.6g} -> {e1:.6g}")
            require(e1 < e0, "hdiff did not dissipate")
    del st, outs, ws, pf, oracle

    # The k-step paths: `run(state, 5)` is full rounds and a ragged tail
    # round. A dycore k=2 plan runs 2 k-step launches and a 1-step tail on
    # the whole-state kernel; k=3 a 3-step round and a 2-step tail, both
    # k-step launches; hdiff k=2 like dycore k=2. Each against the
    # whole-state plan's run(state, 5): float32 bit for bit (the state stays
    # in float32 between the steps of a round, as a float32 whole-state step
    # stores it); hdiff also in bf16 (every in-kernel step rounds through
    # bf16); a bf16 dycore round rounds once where whole-state steps round
    # every step, so within 0.5, the JAX package's k-step bf16 tolerance.
    # Then the hadv_upwind plan against its unfused plan.
    def state_err(a, b):
        return max(max_err(getattr(a, part)[n], getattr(b, part)[n])
                   for part in ("fields", "stage_tens") for n in a.fields)

    def state_equal(a, b):
        return all(torch.equal(getattr(a, part)[n], getattr(b, part)[n])
                   for part in ("fields", "stage_tens") for n in a.fields)

    paths = (("dycore", 2, launches_of(dycore_kstep=2, dycore_fused=1)),
             ("dycore", 3, launches_of(dycore_kstep=2)),
             ("hdiff", 2, launches_of(hdiff_kstep=2, hdiff=1)))
    for dtype in ("float32", "bfloat16"):
        st = make_state(dtype, seed=4)
        whole = {}
        for op in ("dycore", "hdiff"):
            plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                          op=op, dtype=dtype))
            whole[op] = (plan, plan.run(st, PATH_STEPS))
        for op, k, want_counts in paths:
            plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                          op=op, dtype=dtype, variant="kstep",
                                          k_steps=k))
            require(plan.variant == "kstep" and plan.k_steps == k,
                    f"op={op} k={k} resolved to {plan.variant}/"
                    f"k={plan.k_steps}")
            _build.reset_launches()
            out = plan.run(st, PATH_STEPS)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            label = f"k-step path op={op} k={k} {dtype}"
            say(f"{label}: run({PATH_STEPS}) launches {counts}")
            check(counts == want_counts, f"{label}: launched {counts}, "
                  f"expected {want_counts}")
            if dtype == "float32" and k == KSTEPS[0]:
                kernel = {"dycore": "dycore_kstep", "hdiff": "hdiff_kstep"}[op]
                main_launches[kernel] = counts[kernel]
            check(all(bool(torch.isfinite(out.fields[n]).all()
                           and torch.isfinite(out.stage_tens[n]).all())
                      and tuple(out.fields[n].shape) == (ENSEMBLE,) + GRID
                      for n in out.fields), f"{label}: not finite or "
                  f"misshapen")
            ref_out = whole[op][1]
            err = state_err(out, ref_out)
            if op == "dycore" and dtype == "bfloat16":
                say(f"{label}: vs whole_state run({PATH_STEPS}) err {err:.3g} "
                    f"(atol 0.5)")
                check(err <= 0.5, f"{label}: disagrees with the whole-state "
                      f"plan")
            else:
                say(f"{label}: vs whole_state run({PATH_STEPS}) err {err:.3g} "
                    f"(bit for bit)")
                check(state_equal(out, ref_out), f"{label}: differs from the "
                      f"whole-state plan")
            round_ms = time_ms(lambda: plan.step(st))
            step_ms = time_ms(lambda: whole[op][0].step(st))
            results[(f"round_{op}_k{k}", dtype)] = dict(
                ms=round_ms, per_step_ms=round_ms / k,
                whole_state_step_ms=step_ms)
            say(f"{label}: one round {round_ms:.4f} ms, {round_ms / k:.4f} "
                f"ms a step; one whole-state step {step_ms:.4f} ms")
            del out
        del whole, ref_out

        plan = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                      op="hadv_upwind", dtype=dtype))
        require(plan.variant == "whole_state",
                f"op=hadv_upwind resolved to {plan.variant}")
        _build.reset_launches()
        out = plan.run(st, 1)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        say(f"op=hadv_upwind {dtype}: launches {counts}")
        check(counts == launches_of(hadv=1),
              f"op=hadv_upwind {dtype}: launched {counts}")
        if dtype == "float32":
            main_launches["hadv"] = counts["hadv"]
        oracle = compile(StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE,
                                        op="hadv_upwind", dtype=dtype,
                                        variant="unfused")).run(st, 1)
        err = state_err(out, oracle)
        say(f"op=hadv_upwind {dtype}: vs unfused plan err {err:.3g} (atol "
            f"1e-5)")
        check(err <= 1e-5, f"op=hadv_upwind {dtype}: disagrees with its "
              f"unfused plan")
        del st, out, oracle
        torch.cuda.empty_cache()

    phase_done("phase 4 (main path)")

    # ---- 4b. the planner: compile(tune="measure") ----------------------
    # Each plan of PLANNER_PLANS at the paper's domain: the first measured
    # compile times every candidate kernel tile on the card (a fresh cache
    # under build/, so nothing is read from an earlier run); the pick's
    # step bit for bit and launch for launch equal to the default tile's;
    # a second compile measures nothing and gives the same tile; and
    # report()'s analytic model under h100_sxm beside the measured step,
    # with the modelled bytes of the variant over that step as a rate
    # (prints, not gates: the model is a model). Also the hardware= spec.
    cache_root = ROOT / "build"
    cache_root.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_TUNE_CACHE"] = tempfile.mkdtemp(prefix="tune-",
                                                      dir=cache_root)
    measured = {"n": 0}
    real_measure = autotune.measure_walltime

    def spy(fn, repeats=3, device="cpu"):
        measured["n"] += 1
        return real_measure(fn, repeats=repeats, device=device)

    def variant_bytes(plan, traffic):
        """The modelled bytes of one round of the plan's variant, over the
        ensemble (the models count one member)."""
        if plan.program.op == "dycore":
            key = {"per_field": "fused", "whole_state": "fused_whole",
                   "kstep": "fused_kstep"}[plan.variant]
            return ENSEMBLE * traffic[key]["total"]
        return ENSEMBLE * traffic["stream_per_round"]

    autotune.measure_walltime = spy
    for op, variant, k, dtype in PLANNER_PLANS:
        prog = StencilProgram(grid_shape=GRID, ensemble=ENSEMBLE, op=op,
                              variant=variant, k_steps=k, dtype=dtype)
        label = f"planner op={op} {prog.variant}/k={prog.k_steps} {dtype}"
        default = compile(prog)
        n0, hits0 = measured["n"], autotune.TUNE_CACHE_STATS["hits"]
        tuned = compile(prog, tune="measure")
        rep = tuned.report()
        json.dumps(rep)
        tuning = rep["tuning"]
        check(not tuning["cached"]
              and measured["n"] - n0 == len(tuning["measured"]) > 1,
              f"{label}: measured {measured['n'] - n0} candidates, "
              f"{tuning}")
        ms = {t: s * 1e3 for t, s in tuning["measured"].items()}
        say(f"{label}: {len(ms)} tiles timed, ms by tile "
            + json.dumps(ms) + f"; pick {tuning['kernel_tile']} "
            f"{tuning['measured_s'] * 1e3:.4f} ms (request {tuning['tile']}),"
            f" default {tuning['default_tile']} "
            f"{ms[tuning['default_tile']]:.4f} ms")
        check(tuning["measured_s"] <= tuning["measured"][
            tuning["default_tile"]], f"{label}: the pick is slower than the "
              f"default in its own measurement")
        st = make_state(dtype, seed=6)
        _build.reset_launches()
        got = tuned.step(st)
        torch.cuda.synchronize()
        tuned_counts = dict(_build.LAUNCHES)
        _build.reset_launches()
        want = default.step(st)
        torch.cuda.synchronize()
        check(tuned_counts == dict(_build.LAUNCHES)
              and sum(tuned_counts.values()) == tuned.pallas_calls_per_round,
              f"{label}: launches {tuned_counts}, default's "
              f"{dict(_build.LAUNCHES)}")
        check(state_equal(got, want), f"{label}: the pick's step differs "
              f"from the default tile's")
        n1, hits1 = measured["n"], autotune.TUNE_CACHE_STATS["hits"]
        again = compile(prog, tune="measure")
        check(measured["n"] == n1 and again.report()["tuning"]["cached"]
              and autotune.TUNE_CACHE_STATS["hits"] == hits1 + 1 > hits0
              and again.tile == tuned.tile,
              f"{label}: the second compile measured "
              f"{measured['n'] - n1} tiles, tile {again.tile} against "
              f"{tuned.tile}")
        step_ms = time_ms(lambda: tuned.step(st))
        default_ms = time_ms(lambda: default.step(st))
        model = rep["model"]
        # the model's window covers one field of one member (vadvc's folds
        # the ensemble and the fields): scaled to the round's work
        model_round_us = model["time_us"] * (
            1 if op == "vadvc" else ENSEMBLE * prog.n_fields)
        nbytes = variant_bytes(tuned, rep["traffic"])
        tb_s = nbytes / (step_ms * 1e-3) / 1e12
        results[(f"planner_{op}_{tuned.variant}_k{tuned.k_steps}", dtype)] \
            = dict(pick=tuning["kernel_tile"],
                   pick_measured_ms=tuning["measured_s"] * 1e3,
                   default=tuning["default_tile"],
                   default_measured_ms=ms[tuning["default_tile"]],
                   tiles_ms=ms, step_ms=step_ms, default_step_ms=default_ms,
                   model_us=model["time_us"],
                   model_round_us=model_round_us,
                   model_bottleneck=model["bottleneck"],
                   model_window=list(tuned.model_window().tile),
                   modelled_bytes=nbytes, achieved_tb_per_s=tb_s)
        say(f"{label}: step {step_ms:.4f} ms at the pick, {default_ms:.4f} "
            f"ms at the default (median of {REPS} calls, CUDA events); "
            f"model under {model['hardware']}: {model['time_us']:.3f} us "
            f"({model['bottleneck']}, window {tuned.model_window().tile}), "
            f"{model_round_us:.1f} us for the round's fields and members; "
            f"modelled bytes {nbytes / 1e6:.1f} MB over the step: "
            f"{tb_s:.3f} TB/s against 3.35")
        p9 = compile(dataclasses.replace(prog, hardware="power9")).report()
        check(p9["model"]["hardware"] == "power9"
              and p9["model"]["spec_fingerprint"]
              == hwspec.load_spec("power9").fingerprint
              and rep["model"]["hardware"] == "h100_sxm",
              f"{label}: hardware= models {p9['model']}")
        del st, got, want
    autotune.measure_walltime = real_measure
    say(f"planner: {measured['n']} tiles measured; tuning cache "
        f"{autotune.TUNE_CACHE_STATS} in {os.environ['REPRO_TUNE_CACHE']}")
    torch.cuda.empty_cache()

    phase_done("phase 4b (planner)")

    # ---- 4c. pipelines -------------------------------------------------
    # The flagship chain hadv_upwind -> vadvc_update -> hdiff as ONE plan
    # at the paper's domain, fp32 and bf16: 3 launches a round, bit for bit
    # its three solo plans run one after the other, and within tolerance
    # of the chain's unfused plan (the plain versions on the card, no
    # launch); the k=2 plan's round bit for bit two rounds (6 launches) and
    # its run(5) five chain steps; the vadvc_update plan (1 launch) bit for
    # bit the vadvc step then f + dt * stage; asselin (no launch); the
    # hadv_upwind -> hdiff[u,v] binding; the chain step, the solo steps,
    # hdiff's pad and crop, a profiled step by kernel group, and the
    # model's bytes over the steps (`pipeline` lines).
    pipe_launches = {}
    for dtype in ("float32", "bfloat16"):
        st = make_state(dtype, seed=7)
        kw = dict(grid_shape=GRID, ensemble=ENSEMBLE, dtype=dtype)
        label = f"pipeline {dtype}"
        chain = compile(PipelineProgram(stages=PIPELINE, **kw))
        check(chain.variant == "whole_state" and chain.k_steps == 1
              and chain.pallas_calls_per_round == 3 and chain.tile is None,
              f"{label}: resolved to {chain.variant}/k={chain.k_steps}, "
              f"{chain.pallas_calls_per_round} launches a round")
        _build.reset_launches()
        out = chain.step(st)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        say(f"{label}: {' -> '.join(PIPELINE)} step launches {counts}")
        check(counts == launches_of(hadv=1, vadvc=1, hdiff=1),
              f"{label}: launched {counts}")
        if dtype == "float32":
            pipe_launches = {k: counts[k] for k in ("hadv", "vadvc",
                                                    "hdiff")}
        check(all(tuple(out.fields[n].shape) == (ENSEMBLE,) + GRID
                  and bool(torch.isfinite(out.fields[n]).all()
                           and torch.isfinite(out.stage_tens[n]).all())
                  for n in out.fields), f"{label}: not finite or misshapen")
        solos = [compile(StencilProgram(op=op, **kw)) for op in PIPELINE]
        ref = st
        for plan in solos:
            ref = plan.step(ref)
        check(state_equal(out, ref), f"{label}: the chain differs from its "
              f"solo plans run in sequence")
        unfused = compile(PipelineProgram(stages=PIPELINE, variant="unfused",
                                          **kw))
        _build.reset_launches()
        plain_out = unfused.step(st)
        torch.cuda.synchronize()
        check(not any(_build.LAUNCHES.values()),
              f"{label}: the unfused chain launched {dict(_build.LAUNCHES)}")
        d_f = (stacked(out, "fields").float()
               - stacked(plain_out, "fields").float()).abs()
        err_f, err_s = float(d_f.max()), max(
            max_err(out.stage_tens[n], plain_out.stage_tens[n])
            for n in out.fields)
        if dtype == "float32":
            # The stage is vadvc's output: vadvc's tolerance. The field
            # then passes hdiff from inputs ~1e-8 apart, so a limiter branch
            # that sits within noise of flipping may flip (check_fused's
            # limits): 1e-5 plus the flip bound of the hdiff stage's input
            # (the plain hadv and vadvc_update steps' fields).
            f2 = stacked(compile(StencilProgram(
                op="vadvc_update", variant="unfused", **kw)).step(compile(
                    StencilProgram(op="hadv_upwind", variant="unfused",
                                   **kw)).step(st)), "fields")
            flip = fused_ref.limiter_flip_bound(f2, coeff=chain.program.coeff)
            excess = float((d_f - flip).max())
            say(f"{label}: bit for bit its solo sequence; vs the unfused "
                f"chain (plain versions, 0 launches) stage err {err_s:.3g} "
                f"(atol 2e-4), field err {err_f:.3g} (atol 1e-5 + flip "
                f"bound, excess {excess:.3g}), "
                f"{float(torch.where(flip > 0, 0.0, d_f).max()):.3g} off "
                f"the {int((flip > 0).sum())} fragile points")
            ok = err_s <= 2e-4 and excess <= 1e-5
            del f2, flip
        else:
            # the JAX package's bf16 tolerance
            say(f"{label}: bit for bit its solo sequence; vs the unfused "
                f"chain (plain versions, 0 launches) field err {err_f:.3g}, "
                f"stage err {err_s:.3g} (atol 0.25)")
            ok = err_f <= 0.25 and err_s <= 0.25
        check(ok, f"{label}: disagrees with the unfused chain")
        del plain_out, ref, d_f

        two = compile(PipelineProgram(stages=PIPELINE, variant="kstep",
                                      k_steps=2, **kw))
        check(two.pallas_calls_per_round == 6, f"{label} k=2: "
              f"{two.pallas_calls_per_round} launches a round")
        _build.reset_launches()
        got = two.step(st)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == launches_of(hadv=2, vadvc=2, hdiff=2),
              f"{label} k=2: a round launched {counts}")
        check(state_equal(got, chain.step(out)), f"{label} k=2: the round "
              f"differs from two chain rounds")
        _build.reset_launches()
        got = two.run(st, PATH_STEPS)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == launches_of(hadv=PATH_STEPS, vadvc=PATH_STEPS,
                                    hdiff=PATH_STEPS),
              f"{label} k=2: run({PATH_STEPS}) launched {counts}")
        check(state_equal(got, chain.run(st, PATH_STEPS)),
              f"{label} k=2: run({PATH_STEPS}) differs from {PATH_STEPS} "
              f"chain steps")
        say(f"{label} k=2: a round (6 launches) bit for bit two chain "
            f"rounds; run({PATH_STEPS}) launches {counts}, bit for bit "
            f"{PATH_STEPS} chain steps")
        del got

        vu = compile(StencilProgram(op="vadvc_update", **kw))
        _build.reset_launches()
        got = vu.step(st)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        solo_v = compile(StencilProgram(op="vadvc", **kw)).step(st)
        stage = stacked(solo_v, "stage_tens")
        check(counts == launches_of(vadvc=1)
              and torch.equal(stacked(got, "stage_tens"), stage)
              and torch.equal(stacked(got, "fields"),
                              stacked(st, "fields") + vu.program.dt * stage),
              f"{label}: the vadvc_update plan launched {counts} or differs "
              f"from the vadvc step then f + dt * stage")
        asl = compile(StencilProgram(op="asselin", **kw))
        _build.reset_launches()
        got = asl.step(st)
        torch.cuda.synchronize()
        prog = asl.program
        check(not any(_build.LAUNCHES.values()) and torch.equal(
            stacked(got, "fields"), stacked(st, "fields") + prog.coeff
            * prog.dt * (stacked(st, "tens") - stacked(st, "stage_tens"))),
            f"{label}: asselin launched {dict(_build.LAUNCHES)} or differs "
            f"from its filter")
        bind = compile(PipelineProgram(stages=(
            PipelineStage("hadv_upwind"),
            PipelineStage("hdiff", fields=("u", "v"))), **kw))
        _build.reset_launches()
        got = bind.step(st)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        adv = solos[0].step(st)
        full = solos[2].step(adv)
        check(counts == launches_of(hadv=1, hdiff=1) and all(
            torch.equal(got.fields[n], (full if n in ("u", "v") else adv)
                        .fields[n])
            and torch.equal(got.stage_tens[n], st.stage_tens[n])
            for n in st.fields), f"{label}: hadv_upwind -> hdiff[u,v] "
              f"launched {counts} or differs from its solo plans")
        say(f"{label}: vadvc_update 1 launch, bit for bit vadvc then f + dt "
            f"* stage; asselin 0 launches; hadv_upwind -> hdiff[u,v] "
            f"launches {counts}, u and v as hdiff leaves them, t and pp as "
            f"hadv does")
        del got, solo_v, stage, adv, full

        # The chain step against its solo steps, and hdiff's own wrap pad
        # and the copy its crop costs the next step (the stack of the
        # cropped views), timed at the solo shape.
        fs = stacked(st, "fields")
        halo = 2
        padded = fused_ref.pad_periodic(fs, halo)
        cropped = dycore.unstack_state(
            padded[..., halo:halo + ny, halo:halo + nx], fields.PROGNOSTIC)
        chain_ms = time_ms(lambda: chain.step(st))
        solo_ms = {op: time_ms(lambda plan=plan: plan.step(st))
                   for op, plan in zip(PIPELINE, solos)}
        # queued back to back: a by-call time also holds the host's gap
        # before a step's first launch, once for the chain, once a solo step
        chain_queued_ms = stream_ms(lambda: chain.step(st))
        solo_queued_ms = {op: stream_ms(lambda plan=plan: plan.step(st))
                          for op, plan in zip(PIPELINE, solos)}
        pad_ms = time_ms(lambda: fused_ref.pad_periodic(fs, halo))
        crop_ms = time_ms(lambda: dycore.stack_state(cropped))
        ss = stacked(st, "stage_tens")
        update_ms = time_ms(lambda: fs + chain.program.dt * ss)
        split = device_breakdown(lambda: chain.step(st), pipeline_category)
        traffic = chain.report()["traffic"]
        chained = ENSEMBLE * traffic["chained_per_round"]
        sequential = ENSEMBLE * traffic["sequential_per_round"]
        solo_sum = sum(solo_ms.values())
        r = dict(chain_ms=chain_ms, solo_ms=solo_ms, solo_sum_ms=solo_sum,
                 chain_queued_ms=chain_queued_ms,
                 solo_queued_ms=solo_queued_ms,
                 solo_queued_sum_ms=sum(solo_queued_ms.values()),
                 pad_ms=pad_ms, crop_ms=crop_ms, pad_crop_ms=pad_ms + crop_ms,
                 update_ms=update_ms, profiled_step=split,
                 chained_per_round_bytes=chained,
                 sequential_per_round_bytes=sequential,
                 chained_tb_per_s=chained / (chain_ms * 1e-3) / 1e12,
                 sequential_tb_per_s_over_chain=(
                     sequential / (chain_ms * 1e-3) / 1e12),
                 sequential_tb_per_s_over_solo=(
                     sequential / (solo_sum * 1e-3) / 1e12))
        results[("pipeline", dtype)] = r
        say(f"pipeline {dtype} " + json.dumps(r))
        say(f"{label}: chain step {chain_ms:.4f} ms against the solo steps' "
            f"{solo_sum:.4f} ms (" + ", ".join(
                f"{op} {ms:.4f}" for op, ms in solo_ms.items())
            + f"); queued {chain_queued_ms:.4f} against "
            f"{r['solo_queued_sum_ms']:.4f}; hdiff's pad {pad_ms:.4f} ms "
            f"+ crop copy {crop_ms:.4f} "
            f"ms; modelled "
            f"chained {chained / 1e6:.1f} MB, sequential "
            f"{sequential / 1e6:.1f} MB: {r['chained_tb_per_s']:.3f} TB/s "
            f"over the chain step")
        del st, out, fs, ss, padded, cropped, chain, two, solos
        torch.cuda.empty_cache()

    phase_done("phase 4c (pipelines)")

    # ---- 5. the NeroEngine entry point ---------------------------------
    # plan + run for hdiff and vadvc at the paper's domain in both dtypes,
    # and copy, on the card: each result against the direct kernel call
    # with the tile the plan's window maps to (bit for bit), against its
    # plain version, copy also against its input bit for bit. Then the
    # paper's "auto-tuned" mode (measured picks) beside the model's, and
    # the copy kernel's sustained rate, at the paper's domain (which fits
    # the 50 MB L2, so repeated copies read L2) and at the main path's
    # field-stacked state size (268 MB, which does not).
    eng = NeroEngine()
    fid = hwspec.execution_fidelity()
    say(f"engine: hierarchy of {fid['spec']} ({fid['spec_fingerprint']}); "
        f"fidelity {fid}")
    check(fid["spec"] == "h100_sxm" and fid["walltime_trustworthy"],
          f"execution fidelity: {fid}")
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        rtol = 0.0 if dtype == torch.float32 else BF16_RTOL
        src = torch.randn(GRID, generator=gen, device=dev).to(dtype)
        vargs = [torch.randn(GRID, generator=gen, device=dev).to(dtype)
                 for _ in range(4)]
        vargs.insert(1, 0.15 * torch.randn(nz, ny, nx + 1, generator=gen,
                                           device=dev).to(dtype))
        for op, args, direct, plain, tol in (
                ("hdiff", (src,), hdiff_cuda, hdiff_ref.hdiff, 1e-5),
                ("vadvc", tuple(vargs), vadvc_cuda, vadvc_ref.vadvc, 2e-4)):
            tuned = eng.plan(op, GRID, dtype)
            tile = tiling.cuda_tile_for(tuned.plan)
            _build.reset_launches()
            got = eng.run(tuned, *args)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            label = f"engine {op} {dn}"
            check(counts == launches_of(**{op: 1}),
                  f"{label}: launched {counts}")
            check(torch.equal(got, direct(*args, tile=tile)),
                  f"{label}: differs from the direct kernel call")
            check(torch.equal(got, direct(*args)),
                  f"{label}: differs from the kernel at its default tile")
            want = plain(*(a.float() for a in args))
            d = (got.float() - want).abs()
            err, excess = float(d.max()), float((d - rtol * want.abs()).max())
            check(excess <= tol, f"{label}: disagrees with its plain version")
            ms = time_ms(lambda: eng.run(tuned, *args))
            queued_ms = stream_ms(lambda: eng.run(tuned, *args))
            model_ms = tuned.est.time_s * 1e3
            # each operand read once and the output written once
            b_ms, _ = bound((sum(a.numel() for a in args) + got.numel())
                            * got.element_size(), 0.0)
            results[(f"engine_{op}", dn)] = dict(
                window=list(tuned.plan.tile), tile=[tile.ty, tile.tx],
                model_ms=model_ms, ms=ms, queued_ms=queued_ms, bound_ms=b_ms,
                err=err)
            say(f"{label}: window {tuned.plan.tile} -> CUDA tile "
                f"{tile.ty}x{tile.tx} ({tile.threads} threads); modelled "
                f"{model_ms:.4f} ms under h100_sxm ({tuned.est.bottleneck}), "
                f"measured {ms:.4f} ms a call ({queued_ms:.4f} ms queued "
                f"back to back), byte bound {b_ms:.4f} ms; vs direct call "
                f"bit for bit; vs plain "
                f"err {err:.3g}, excess {excess:.3g} (atol {tol} + "
                f"{rtol:.3g}|want|)")
            del got, want, d
        try:
            eng.run(eng.plan("hdiff", GRID, dtype), src.cpu())
            check(False, f"engine hdiff {dn}: CPU operands did not raise")
        except ValueError as e:
            say(f"engine hdiff {dn}: CPU operands raise: {e}")
        del src, vargs

    # The paper's "auto-tuned" mode: every candidate window timed on the
    # card through the kernel tile it maps to (windows that share a tile
    # share one timing).
    src = torch.randn(GRID, generator=gen, device=dev)
    model_pick = eng.plan("hdiff", GRID, torch.float32)
    timed = {}

    def measure(plan):
        tile = tiling.cuda_tile_for(plan)
        key = (tile.ty, tile.tx)
        if key not in timed:
            timed[key] = autotune.measure_walltime(
                lambda: hdiff_cuda(src, tile=tile), repeats=5, device=dev)
        return timed[key]

    measured_pick = eng.plan("hdiff", GRID, torch.float32, measure=measure)
    m_tile = tiling.cuda_tile_for(model_pick.plan)
    t_tile = tiling.cuda_tile_for(measured_pick.plan)
    results[("engine_hdiff_autotuned", "float32")] = dict(
        model_window=list(model_pick.plan.tile),
        model_tile=[m_tile.ty, m_tile.tx],
        model_tile_ms=timed[(m_tile.ty, m_tile.tx)] * 1e3,
        measured_window=list(measured_pick.plan.tile),
        measured_tile=[t_tile.ty, t_tile.tx],
        measured_ms=measured_pick.pareto[0][0] * 1e3,
        tiles_timed=len(timed))
    say(f"engine hdiff float32 auto-tuned: {len(timed)} kernel tiles timed; "
        f"model's pick {model_pick.plan.tile} -> {m_tile.ty}x{m_tile.tx} "
        f"{timed[(m_tile.ty, m_tile.tx)] * 1e3:.4f} ms; measured pick "
        f"{measured_pick.plan.tile} -> {t_tile.ty}x{t_tile.tx} "
        f"{measured_pick.pareto[0][0] * 1e3:.4f} ms")
    check(measured_pick.pareto[0][0] <= timed[(m_tile.ty, m_tile.tx)],
          "auto-tuned hdiff: the measured pick is slower than the model's")
    del src, timed

    # copy: the engine's run at the paper's domain as a 2-D (rows, cols)
    # view, then the rates at both sizes.
    tuned = eng.plan("copy", GRID, torch.float32)
    for label, rows in COPY_SIZES:
        src = torch.randn(rows, nx, generator=gen, device=dev)
        src[0, :4] = torch.tensor([-0.0, float("nan"), float("inf"), -1.0],
                                  device=dev)
        _build.reset_launches()
        got = eng.run(tuned, src)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        check(counts == launches_of(copy=1),
              f"engine copy ({label}): launched {counts}")
        if label == "paper domain":
            main_launches["copy"] = counts["copy"]
        check(torch.equal(got.view(torch.int32), src.view(torch.int32)),
              f"engine copy ({label}): not bitwise equal to its input")
        check(torch.equal(got.view(torch.int32),
                          copy_cuda(src).view(torch.int32)),
              f"engine copy ({label}): differs from the direct kernel call")
        plain = copy_ref.copy_stencil(src)
        check(torch.equal(torch.nan_to_num(got), torch.nan_to_num(plain)),
              f"engine copy ({label}): differs from its plain version")
        err = float((torch.nan_to_num(got) - torch.nan_to_num(plain))
                    .abs().max())
        nbytes = 2 * src.numel() * src.element_size()
        t = copy_times(copy_cuda, src)
        ms, queued_ms, prof_ms = t["ms"], t["queued_ms"], t["profiler_ms"]
        library_ms, library_queued_ms, library_prof_ms = (
            t["library_ms"], t["library_queued_ms"],
            t["library_profiler_ms"])
        plain_ms = time_ms(lambda: copy_ref.copy_stencil(src))
        b_ms, b_by = bound(nbytes, 0.0)
        results[("copy_" + label.replace(" ", "_"), "float32")] = dict(
            err=err, ms=ms, queued_ms=queued_ms, profiler_ms=prof_ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library_queued_ms=library_queued_ms,
            library_profiler_ms=library_prof_ms, bound_ms=b_ms,
            bound_by=b_by, mbytes=nbytes / 2 / 1e6,
            tb_per_s=nbytes / ms * 1e-9,
            queued_tb_per_s=nbytes / queued_ms * 1e-9,
            library_tb_per_s=nbytes / library_ms * 1e-9,
            library_queued_tb_per_s=nbytes / library_queued_ms * 1e-9,
            model_ms=tuned.est.time_s * 1e3)
        fmt = lambda v: "not seen" if v is None else f"{v:.4f} ms"
        say(f"engine copy ({label}, {tuple(src.shape)}, {nbytes / 2 / 1e6:.1f} "
            f"MB): window {tuned.plan.tile} (unused by the kernel); bitwise "
            f"equal to its input and the direct call; kernel: call "
            f"{ms:.4f} ms = {nbytes / ms * 1e-9:.3f} TB/s, queued "
            f"{queued_ms:.4f} ms = {nbytes / queued_ms * 1e-9:.3f} TB/s, "
            f"profiler {fmt(prof_ms)}; Tensor.copy_: call {library_ms:.4f} "
            f"ms, queued {library_queued_ms:.4f} ms = "
            f"{nbytes / library_queued_ms * 1e-9:.3f} TB/s, profiler "
            f"{fmt(library_prof_ms)}; plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms" + (" (L2-resident: not a device-memory rate)"
                                if rows == nz * ny else ""))
        del src, got, plain
    big = results[("copy_field-stacked_state", "float32")]
    results[("copy", "float32")] = big
    say(f"copy bandwidth: {big['queued_tb_per_s']:.3f} TB/s sustained by "
        f"the copy kernel queued back to back "
        f"({big['queued_tb_per_s'] / (HBM_BYTES_PER_S * 1e-12):.3f} of the "
        f"data sheet's 3.35; {big['tb_per_s']:.3f} a single call), "
        f"Tensor.copy_ {big['library_queued_tb_per_s']:.3f} TB/s queued "
        f"({big['library_tb_per_s']:.3f} a single call), 268 MB read and "
        f"written, on {card}")
    torch.cuda.empty_cache()

    phase_done("phase 5 (NeroEngine)")

    # ---- 6. LM serving --------------------------------------------------
    path_launches = serve_phase(torch, dev, check, results, main_launches)

    phase_done("phase 6 (LM serving)")

    # ---- 7. LM training -------------------------------------------------
    train_launches = train_phase(torch, dev, check, results)
    # the kernels line reads the xent kernel on recurrentgemma's training
    # path, the one that runs all three LM kernels
    main_launches["xent"] = train_launches[TRAIN_RUNS[1][0]]["xent"]

    phase_done("phase 7 (LM training)")

    # ---- 8. forecast serving ----------------------------------------------
    forecast_launches = forecast_phase(torch, dev, check, results)
    main_launches["slot_guard"] = forecast_launches["slot_guard"]

    phase_done("phase 8 (forecast serving)")

    # ---- 9. LM families ---------------------------------------------------
    family_serve, family_train = family_phase(torch, dev, check, results)

    phase_done("phase 9 (LM families)")

    # ---- 10. the weather plans on a mesh ----------------------------------
    mesh_launches = mesh_phase(torch, dev, check, results, make_state)

    phase_done("phase 10 (mesh)")

    # ---- 11. the forecast engine on a mesh ----------------------------------
    forecast_mesh_launches = forecast_mesh_phase(torch, dev, check, results,
                                                 card)

    phase_done("phase 11 (forecast on a mesh)")

    # ---- 12. LM training on a device mesh -----------------------------------
    train_mesh_launches = train_mesh_phase(torch, dev, check, results)

    phase_done("phase 12 (LM training on a mesh)")

    # ---- 13. the dry-run against the card ----------------------------------
    dryrun_phase(torch, check, results)

    phase_done("phase 13 (dry-run against the card)")

    # ---- 14. the port's examples ---------------------------------------------
    example_launches = examples_phase(check, results)

    phase_done("phase 14 (examples)")

    # ---- the kernels line -----------------------------------------------
    sources = {"dycore_fused": ("src/repro_torch/csrc/dycore_fused.cu",
                                "src/repro/kernels/dycore_fused/fused.py:276"),
               "hdiff": ("src/repro_torch/csrc/hdiff.cu",
                         "src/repro/kernels/hdiff/hdiff.py:171"),
               "vadvc": ("src/repro_torch/csrc/vadvc.cu",
                         "src/repro/kernels/vadvc/vadvc.py:111"),
               "dycore_kstep": ("src/repro_torch/csrc/dycore_kstep.cu",
                                "src/repro/kernels/dycore_fused/fused.py:434"),
               "hdiff_kstep": ("src/repro_torch/csrc/hdiff.cu",
                               "src/repro/kernels/hdiff/hdiff.py:128"),
               "hadv": ("src/repro_torch/csrc/hadv.cu",
                        "src/repro/kernels/hadv/hadv.py:47"),
               "copy": ("src/repro_torch/csrc/copy.cu",
                        "src/repro/kernels/copy_stencil/copy_stencil.py:17"),
               "flash_attn": ("src/repro_torch/csrc/flash_attn_tc.cu",
                              "src/repro/kernels/flash_attention/flash.py:77"),
               "lru_scan": ("src/repro_torch/csrc/lru_scan.cu",
                            "src/repro/kernels/lru_scan/lru_scan.py:41"),
               "xent": ("src/repro_torch/csrc/xent_tc.cu",
                        "src/repro/kernels/xent/xent.py:68"),
               "slot_guard": ("src/repro_torch/csrc/slot_guard.cu",
                              "src/repro/weather/program.py:263")}
    # the LM paths run flash attention and xent in bf16, the rest in fp32
    keys = {"flash_attn": ("flash_attn", "bfloat16"),
            "xent": (f"xent_{TRAIN_RUNS[1][0]}", "bfloat16")}
    # the design of each kernel this file's last redesign changed
    designs = {"vadvc": "a warp a row segment, levels through a cp.async "
                        "ring, (c, d) and u_pos of the column in shared "
                        "memory; staggered or periodic wcon",
               "hadv": "a warp a (segment, strip) row stream through a "
                       "cp.async ring, 16 bytes a lane of a row; passthrough "
                       "or periodic mode"}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[keys.get(name, (name, "float32"))]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        if name in designs:
            kernels[-1]["design"] = designs[name]
        if name == "slot_guard":
            kernels[-1]["note"] = ("replaces an XLA-fused jnp function, "
                                   "not a pl.pallas_call; launches: the "
                                   "forecast drain's, one a lane round")
            kernels[-1]["bf16"] = {
                key: results[("slot_guard", "bfloat16")][key]
                for key in ("ms", "queued_ms", "plain_ms", "bound_ms")}
        if name in ("dycore_fused", "dycore_kstep", "hdiff"):
            # the forecast drain's own launches (phase 8)
            kernels[-1].setdefault("paths", {})["forecast"] = {
                "launches": forecast_launches[name]}
        if name in forecast_mesh_launches:
            # the mesh forecast drain's own launches, every shard's (phase
            # 11); the guard's: 4 partials and a combine a lane round
            kernels[-1].setdefault("paths", {})["forecast_mesh"] = {
                "launches": forecast_mesh_launches[name]}
            if name == "slot_guard":
                g = results[("forecast_mesh_guard", "float32")]
                kernels[-1]["paths"]["forecast_mesh"].update(
                    {key: g[key] for key in ("ms", "queued_ms", "shard_ms",
                                             "shard_queued_ms", "bound_ms",
                                             "err")})
        if name in pipe_launches:
            # the flagship chain's own launches (one fp32 step)
            kernels[-1].setdefault("paths", {})["pipeline"] = {
                "launches": pipe_launches[name]}
        if name in ("flash_attn", "lru_scan", "xent"):
            # each serving and training path's own launches; flash also its
            # own times at that model's prefill shape (whisper's: its
            # encoder's), xent at that model's training shape; phase 9's
            # paths run no LRU
            serving = dict(path_launches)
            training = dict(train_launches)
            if name != "lru_scan":
                serving.update(family_serve)
                training.update(family_train)
            paths = {} if name == "xent" else {
                arch: {"launches": n[name]} for arch, n in serving.items()}
            paths.update({f"train {arch}": {"launches": n[name]}
                          for arch, n in training.items()})
            timed = []
            if name == "flash_attn":
                timed = [(arch, (key, "bfloat16")) for (_, key), arch in
                         zip(FLASH_TIMES, SERVE_ARCHS)]
                timed += [(arch, (f"flash_attn_{arch}", "bfloat16"))
                          for arch in FAMILY_ARCHS
                          if (f"flash_attn_{arch}", "bfloat16") in results]
            elif name == "xent":
                timed = [(f"train {arch}", (f"xent_{arch}", "bfloat16"))
                         for arch in training]
            for path, key in timed:
                r = results[key]
                paths[path].update(
                    shape=r["shape"], max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
                for extra in ("bound_fp32_cores_ms", "ms_each", "queued_ms",
                              "library_queued_ms"):
                    if extra in r:
                        paths[path][extra] = r[extra]
            # phase 12's fit(mesh=) runs on a (1, 1) mesh, by arch
            paths.update({f"train_mesh {arch}": {"launches": n[name]}
                          for arch, n in train_mesh_launches.items()})
            kernels[-1]["paths"] = paths
        if name == "xent":
            kernels[-1]["queued_ms"] = r["queued_ms"]
        if name in ("flash_attn", "xent"):
            # the times above are the bf16 tensor-core kernel's; fp32
            # operands take the fp32-core kernel
            kernels[-1]["fp32_source"] = source.replace("_tc.cu", ".cu")
        if name == "lru_scan":
            rev = results[("lru_scan_reverse", "float32")]
            kernels[-1]["reverse_ms"] = rev["ms"]
            kernels[-1]["reverse_queued_ms"] = rev["queued_ms"]
        if name == "dycore_fused":
            # the main path's peak device memory over run(state, 10), above
            # the state resident before it
            kernels[-1]["run_peak_bytes"] = results[
                ("main_step", "float32")]["run_peak_bytes"]
        for extra in ("queued_ms", "profiler_ms", "library_queued_ms",
                      "library_profiler_ms", "per_step_ms",
                      "whole_state_launches_ms", "hdiff_launches_ms",
                      "staggered_ms", "staggered_queued_ms",
                      "passthrough_ms", "passthrough_queued_ms"):
            if extra in r and name not in ("flash_attn", "xent"):
                kernels[-1][extra] = r[extra]
        if example_launches.get(name):
            # the examples' launches, every run's (phase 14)
            kernels[-1].setdefault("paths", {})["examples"] = {
                "launches": example_launches[name]}
        if name in mesh_launches:
            # the mesh phase's launches, every shard's, by plan (phase 10)
            by = mesh_launches[name]
            kernels[-1].setdefault("paths", {})["mesh"] = {
                "launches": sum(by.values()), "by_plan": by}
        if name == "dycore_kstep":
            r3 = results[(f"dycore_kstep_k{KSTEPS[1]}", "float32")]
            kernels[-1][f"k{KSTEPS[1]}"] = {
                key: r3[key] for key in ("ms", "queued_ms", "per_step_ms",
                                         "whole_state_launches_ms",
                                         "plain_ms", "bound_ms")}
        if name == "hdiff_kstep":
            r3 = results[(f"hdiff_kstep_k{KSTEPS[1]}", "float32")]
            kernels[-1][f"k{KSTEPS[1]}"] = {
                key: r3[key] for key in ("ms", "queued_ms",
                                         "hdiff_launches_ms", "plain_ms",
                                         "bound_ms")}
    say("library_ms: no single PyTorch call computes the fused dycore step "
        "or its k-step round, the limited compound hdiff or its k-step "
        "round, or the vadvc Thomas sweep; hadv's is one conv2d over the "
        "wrap-padded stack; copy's is Tensor.copy_ into a preallocated tensor; "
        "flash_attn's is scaled_dot_product_attention (enable_gqa; causal, "
        "but non-causal at whisper's encoder) at recurrentgemma-9b's "
        "prefill shape and at each path's own; none computes the LRU sweep; "
        "xent's is a pair of calls, h @ head then F.cross_entropy, at "
        "recurrentgemma-9b's training shape; none computes the slot "
        "guard's digest")
    if failures:
        raise SmokeFailure(f"{len(failures)} check(s) failed: "
                           + "; ".join(failures))
    for (name, dn), r in sorted(results.items()):
        say(f"time {name} {dn}: " + json.dumps(r))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--copy-times"] and len(sys.argv) == 3:
            sys.exit(copy_times_of(Path(sys.argv[2])))
        if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
            sys.exit(kernel_times_of(Path(sys.argv[2])))
        if sys.argv[1:] == ["--train-mesh"]:
            sys.exit(train_mesh_main())
        if sys.argv[1:] == ["--examples"]:
            sys.exit(examples_main())
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
