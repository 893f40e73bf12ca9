"""Declarative hardware specs: model any machine, measure on the real one.

A port of `repro.core.hwspec`. The paper's headline result is a
cross-machine comparison (NERO, an XCVU37P + HBM2 dataflow fabric, against a
16-core POWER9); this module makes the machine an input. A frozen
`HardwareSpec` is loaded from versioned JSON under `src/repro_torch/specs/`,
schema-validated with errors that name the bad field, and
content-fingerprinted so every modelled or measured number can record which
machine description produced it.

The port ships the JAX package's three specs byte for byte (`tpu_v5e`,
`power9`, `nero_ad9h7`, so their fingerprints are the same in both packages)
and its own `h100_sxm`, the card the port runs on, which is its default.

A spec carries:

* the memory hierarchy (`main` -> `near` -> `reg` roles; each level's
  capacity, bandwidth and pJ/byte): NERO's HBM -> URAM/BRAM -> FF chain,
  POWER9's DRAM -> L3 -> L1, the TPU's HBM -> VMEM -> VREG, the H100's
  HBM3 -> shared memory -> registers;
* peak FLOP/s by dtype, idle/peak watts, pJ/flop;
* the collective link (latency, bandwidth, links, pJ/byte);
* per-kernel-class sustained models (`kernel_classes`): the fraction of
  peak main-memory bandwidth a class of kernels sustains, and optionally a
  measured wall power. `"solver"` is an op with a sequential axis (vadvc's
  z-sweep), `"streaming"` any other (hdiff, copy);
* an execution-fidelity block: `jax_backend` and `interpret_fidelity` are
  the JAX package's and stay in the schema as data; the port adds an
  optional `card`, a substring of `torch.cuda.get_device_name()` that names
  the machine, so a walltime counts as the spec's only when measured there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.weather.fields import dtype_name

__all__ = ["SpecValidationError", "MemoryLevel", "Hierarchy",
           "KernelClassModel", "Collective", "HardwareSpec",
           "dtype_bytes", "spec_dir", "available_specs", "load_spec",
           "spec_from_dict", "default_spec_name", "default_spec",
           "execution_fidelity", "KERNEL_CLASSES", "kernel_class_name"]

# Where the versioned spec JSONs live: src/repro_torch/specs/.
_SPEC_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 os.pardir, "specs"))

# The two kernel classes the sustained models are keyed on.
KERNEL_CLASSES = ("streaming", "solver")

_ROLES = ("main", "near", "reg")


class SpecValidationError(ValueError):
    """A hardware-spec JSON failed schema validation; the message names
    the offending field (dotted path) and what was wrong with it."""


def dtype_bytes(dtype) -> int:
    """Bytes per element of a dtype given as a name ("float32",
    "bfloat16"), a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    name = dtype_name(dtype)
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of the near-memory hierarchy."""

    name: str
    capacity_bytes: int
    bandwidth_bytes_per_s: float
    energy_pj_per_byte: float

    def seconds_for(self, nbytes: int) -> float:
        return nbytes / self.bandwidth_bytes_per_s

    def energy_joules_for(self, nbytes: int) -> float:
        return nbytes * self.energy_pj_per_byte * 1e-12


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The per-chip hierarchy, NERO-style: far memory feeds near memory
    feeds registers; the planner places tiles at the deepest level that
    fits. Field names keep the JAX package's TPU spelling (`hbm`/`vmem`/
    `vreg`); a spec's `main`/`near`/`reg` levels map onto them whatever the
    machine calls its memories. The peaks have no default: every machine
    states its own."""

    hbm: MemoryLevel
    vmem: MemoryLevel
    vreg: MemoryLevel
    peak_flops_bf16: float
    peak_flops_fp32: float
    ici_bw: float

    def level_for(self, nbytes: int) -> MemoryLevel:
        """Deepest (fastest) level whose capacity holds `nbytes` (the
        paper's greedy placement: URAM/BRAM if it fits, else HBM)."""
        if nbytes <= self.vreg.capacity_bytes:
            return self.vreg
        if nbytes <= self.vmem.capacity_bytes:
            return self.vmem
        return self.hbm

    def machine_balance(self, dtype="bfloat16") -> float:
        """FLOP:byte ratio at which compute and main-memory time are
        equal: the roofline ridge point (paper Fig. 1)."""
        peak = (self.peak_flops_bf16
                if dtype_bytes(dtype) <= 2 else self.peak_flops_fp32)
        return peak / self.hbm.bandwidth_bytes_per_s


@dataclasses.dataclass(frozen=True)
class KernelClassModel:
    """Sustained-efficiency model for one kernel class on one machine.

    `bw_utilization` derates peak main-memory bandwidth to what this class
    of kernels sustains; `compute_utilization` derates peak FLOP/s.
    `watts`, when given, is the class's sustained wall power and replaces
    the bottom-up traffic-energy estimate."""

    bw_utilization: float
    compute_utilization: float
    watts: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Collective:
    """The inter-device (or accelerator-to-host) link."""

    latency_s: float
    bandwidth_bytes_per_s: float
    links: int = 1
    energy_pj_per_byte: float = 0.0


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A frozen, fingerprinted machine description (see module doc)."""

    name: str
    title: str
    source: str
    schema_version: int
    jax_backend: Optional[str]
    interpret_fidelity: bool
    card: Optional[str]
    main: MemoryLevel
    near: MemoryLevel
    reg: MemoryLevel
    peak_flops: Mapping[str, float]
    idle_watts: float
    peak_watts: float
    energy_pj_per_flop: float
    collective: Collective
    kernel_classes: Mapping[str, KernelClassModel]
    reference_points: Mapping[str, Mapping[str, float]]
    layout: Mapping[str, Tuple[int, ...]]
    near_physical_bytes: int
    host_energy_pj_per_byte: float
    fingerprint: str

    def hierarchy(self) -> Hierarchy:
        """This spec as the planner/perfmodel `Hierarchy` view."""
        return Hierarchy(
            hbm=self.main, vmem=self.near, vreg=self.reg,
            peak_flops_bf16=self.peak_flops["bfloat16"],
            peak_flops_fp32=self.peak_flops["float32"],
            ici_bw=self.collective.bandwidth_bytes_per_s)

    def peak_flops_for(self, dtype) -> float:
        key = dtype_name(dtype)
        if key in self.peak_flops:
            return self.peak_flops[key]
        return (self.peak_flops["bfloat16"] if dtype_bytes(dtype) <= 2
                else self.peak_flops["float32"])

    def kernel_class(self, op) -> KernelClassModel:
        """The sustained model for a `tiling.OpSpec` (or class name)."""
        return self.kernel_classes[kernel_class_name(op)]

    def describe(self) -> Dict[str, Any]:
        """Short JSON-serializable identity block for artifacts (the JAX
        package's keys)."""
        return {"name": self.name, "fingerprint": self.fingerprint,
                "title": self.title, "jax_backend": self.jax_backend,
                "interpret_fidelity": self.interpret_fidelity}


def kernel_class_name(op) -> str:
    """`"solver"` for ops with a sequential axis, else `"streaming"`.
    Accepts a `tiling.OpSpec`-shaped object or a class name."""
    if isinstance(op, str):
        if op not in KERNEL_CLASSES:
            raise KeyError(f"unknown kernel class {op!r}; expected one of "
                           f"{KERNEL_CLASSES}")
        return op
    return "solver" if getattr(op, "seq_axes", ()) else "streaming"


# ---------------------------------------------------------------------------
# Schema validation (every error names the bad field as a dotted path, as
# the JAX package's does)
# ---------------------------------------------------------------------------


def _fail(where: str, field: str, why: str) -> None:
    raise SpecValidationError(f"{where}: field {field!r} {why}")


def _need(d: Mapping, field: str, where: str, types, *,
          positive: bool = False, nonneg: bool = False,
          unit_interval: bool = False):
    path = field
    cur: Any = d
    for part in field.split("."):
        if not isinstance(cur, Mapping) or part not in cur:
            _fail(where, path, "is missing")
        cur = cur[part]
    if types is bool:
        if not isinstance(cur, bool):
            _fail(where, path, f"must be a bool, got {type(cur).__name__}")
        return cur
    if not isinstance(cur, types) or isinstance(cur, bool):
        _fail(where, path, f"must be {getattr(types, '__name__', types)}, "
                           f"got {type(cur).__name__}")
    if isinstance(cur, (int, float)):
        if not math.isfinite(cur):
            _fail(where, path, f"must be finite, got {cur!r}")
        if positive and cur <= 0:
            _fail(where, path, f"must be > 0, got {cur!r}")
        if nonneg and cur < 0:
            _fail(where, path, f"must be >= 0, got {cur!r}")
        if unit_interval and not 0 < cur <= 1:
            _fail(where, path, f"must be in (0, 1], got {cur!r}")
    return cur


def _optional_str(d: Mapping, field: str, where: str) -> Optional[str]:
    value = d.get(field, None)
    if value is not None and not isinstance(value, str):
        _fail(where, field, "must be a string or null")
    return value


def _parse_level(entry: Mapping, where: str, path: str) -> MemoryLevel:
    if not isinstance(entry, Mapping):
        _fail(where, path, "must be an object")
    name = _need(entry, "name", where, str)
    cap = _need(entry, "capacity_bytes", where, (int, float), positive=True)
    bw = _need(entry, "bandwidth_bytes_per_s", where, (int, float),
               positive=True)
    pj = _need(entry, "energy_pj_per_byte", where, (int, float), nonneg=True)
    return MemoryLevel(name=name, capacity_bytes=int(cap),
                       bandwidth_bytes_per_s=float(bw),
                       energy_pj_per_byte=float(pj))


def spec_from_dict(d: Mapping[str, Any],
                   where: str = "<dict>") -> HardwareSpec:
    """Validate a raw spec dict and freeze it into a `HardwareSpec`.

    Raises `SpecValidationError` naming the first bad field (dotted path),
    the same field the JAX package's validator names."""
    if not isinstance(d, Mapping):
        raise SpecValidationError(f"{where}: spec must be a JSON object, "
                                  f"got {type(d).__name__}")
    version = _need(d, "schema_version", where, int)
    if version != 1:
        _fail(where, "schema_version", f"must be 1, got {version!r}")
    name = _need(d, "name", where, str)
    title = _need(d, "title", where, str)
    source = _need(d, "source", where, str)
    backend = _optional_str(d, "jax_backend", where)
    fidelity = _need(d, "interpret_fidelity", where, bool)
    card = _optional_str(d, "card", where)

    levels_raw = _need(d, "memory_levels", where, (list, tuple))
    by_role: Dict[str, MemoryLevel] = {}
    near_physical = None
    for i, entry in enumerate(levels_raw):
        path = f"memory_levels[{i}]"
        if not isinstance(entry, Mapping):
            _fail(where, path, "must be an object")
        role = _need(entry, "role", where, str)
        if role not in _ROLES:
            _fail(where, f"{path}.role",
                  f"must be one of {_ROLES}, got {role!r}")
        if role in by_role:
            _fail(where, f"{path}.role", f"duplicates role {role!r}")
        by_role[role] = _parse_level(entry, where, path)
        if role == "near" and "physical_capacity_bytes" in entry:
            near_physical = int(_need(entry, "physical_capacity_bytes",
                                      where, (int, float), positive=True))
    for role in _ROLES:
        if role not in by_role:
            _fail(where, "memory_levels",
                  f"must define a level with role {role!r}")
    if near_physical is None:
        near_physical = by_role["near"].capacity_bytes

    peaks_raw = _need(d, "peak_flops", where, Mapping)
    for key in ("bfloat16", "float32"):
        _need(d, f"peak_flops.{key}", where, (int, float), positive=True)
    peaks = {str(k): float(v) for k, v in peaks_raw.items()}

    idle = float(_need(d, "idle_watts", where, (int, float), nonneg=True))
    peakw = float(_need(d, "peak_watts", where, (int, float), positive=True))
    if idle > peakw:
        _fail(where, "idle_watts", f"must be <= peak_watts ({peakw}), "
                                   f"got {idle}")
    pj_flop = float(_need(d, "energy_pj_per_flop", where, (int, float),
                          nonneg=True))

    coll = Collective(
        latency_s=float(_need(d, "collective.latency_s", where,
                              (int, float), nonneg=True)),
        bandwidth_bytes_per_s=float(_need(
            d, "collective.bandwidth_bytes_per_s", where, (int, float),
            positive=True)),
        links=int(_need(d, "collective.links", where, int, positive=True)),
        energy_pj_per_byte=float(_need(
            d, "collective.energy_pj_per_byte", where, (int, float),
            nonneg=True)))

    classes: Dict[str, KernelClassModel] = {}
    _need(d, "kernel_classes", where, Mapping)
    for cls in KERNEL_CLASSES:
        bw_u = _need(d, f"kernel_classes.{cls}.bw_utilization", where,
                     (int, float), unit_interval=True)
        cu = _need(d, f"kernel_classes.{cls}.compute_utilization", where,
                   (int, float), unit_interval=True)
        watts = d["kernel_classes"][cls].get("watts", None)
        if watts is not None and (not isinstance(watts, (int, float))
                                  or isinstance(watts, bool) or watts <= 0):
            _fail(where, f"kernel_classes.{cls}.watts",
                  f"must be a positive number or null, got {watts!r}")
        classes[cls] = KernelClassModel(
            bw_utilization=float(bw_u), compute_utilization=float(cu),
            watts=None if watts is None else float(watts))

    refs_raw = d.get("reference_points", {})
    if not isinstance(refs_raw, Mapping):
        _fail(where, "reference_points", "must be an object")
    refs: Dict[str, Dict[str, float]] = {}
    for kname, entry in refs_raw.items():
        if not isinstance(entry, Mapping):
            _fail(where, f"reference_points.{kname}", "must be an object")
        refs[str(kname)] = {str(k): float(v) for k, v in entry.items()}

    layout_raw = d.get("layout", {})
    if not isinstance(layout_raw, Mapping):
        _fail(where, "layout", "must be an object")
    layout = {str(k): tuple(int(x) for x in v)
              for k, v in layout_raw.items()}

    host_pj = d.get("host_energy_pj_per_byte", 0.0)
    if not isinstance(host_pj, (int, float)) or isinstance(host_pj, bool):
        _fail(where, "host_energy_pj_per_byte", "must be a number")

    fingerprint = hashlib.sha256(
        json.dumps(d, sort_keys=True, separators=(",", ":"),
                   default=str).encode()).hexdigest()[:12]

    return HardwareSpec(
        name=name, title=title, source=source, schema_version=version,
        jax_backend=backend, interpret_fidelity=fidelity, card=card,
        main=by_role["main"], near=by_role["near"], reg=by_role["reg"],
        peak_flops=peaks, idle_watts=idle, peak_watts=peakw,
        energy_pj_per_flop=pj_flop, collective=coll,
        kernel_classes=classes, reference_points=refs, layout=layout,
        near_physical_bytes=near_physical,
        host_energy_pj_per_byte=float(host_pj), fingerprint=fingerprint)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

_CACHE: Dict[Tuple[str, str], HardwareSpec] = {}


def spec_dir() -> str:
    return _SPEC_DIR


def available_specs(directory: Optional[str] = None) -> Tuple[str, ...]:
    """Names of every spec JSON shipped under `src/repro_torch/specs/`."""
    directory = directory or _SPEC_DIR
    return tuple(sorted(
        fn[:-len(".json")] for fn in os.listdir(directory)
        if fn.endswith(".json")))


def load_spec(name: str, directory: Optional[str] = None) -> HardwareSpec:
    """Load + validate + fingerprint the named spec (cached)."""
    directory = directory or _SPEC_DIR
    key = (directory, name)
    spec = _CACHE.get(key)
    if spec is not None:
        return spec
    path = os.path.join(directory, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"unknown hardware spec {name!r}; available: "
                       f"{available_specs(directory)}")
    with open(path) as fh:
        try:
            raw = json.load(fh)
        except json.JSONDecodeError as e:
            raise SpecValidationError(f"{path}: not valid JSON: {e}") from e
    spec = spec_from_dict(raw, where=os.path.basename(path))
    if spec.name != name:
        raise SpecValidationError(
            f"{path}: field 'name' must match the file stem {name!r}, "
            f"got {spec.name!r}")
    _CACHE[key] = spec
    return spec


def default_spec_name() -> str:
    """The process's default modelling target: `REPRO_HWSPEC` (env) or the
    H100 SXM the port's kernels are written for."""
    return os.environ.get("REPRO_HWSPEC", "h100_sxm")


def default_spec() -> HardwareSpec:
    return load_spec(default_spec_name())


def execution_fidelity(spec: Optional[HardwareSpec] = None,
                       device="cuda") -> Dict[str, Any]:
    """Which device this process executes on (`device`, and the card's
    name when it is a CUDA device), whether the kernels' plain PyTorch
    versions run in their place (on the CPU), which spec the modelled
    numbers target, and whether measured walltimes count as that machine's:
    only on a CUDA card whose name contains the spec's `card`."""
    spec = spec or default_spec()
    device = torch.device(device)
    on_card = device.type == "cuda" and torch.cuda.is_available()
    card = torch.cuda.get_device_name(device) if on_card else None
    trustworthy = (on_card and spec.card is not None
                   and spec.card in card)
    return {"device": device.type, "card": card,
            "plain_versions": device.type == "cpu",
            "spec": spec.name, "spec_fingerprint": spec.fingerprint,
            "walltime_trustworthy": bool(trustworthy)}
