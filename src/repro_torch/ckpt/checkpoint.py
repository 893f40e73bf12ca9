"""Checkpointing: atomic, keep-N, async save; restore onto a device or a
device mesh.

A port of `repro.ckpt.checkpoint`. The on-disk layout is
the JAX package's, so a checkpoint written by either package restores in
the other: `<dir>/step_<n:08d>/arrays.npz` plus `meta.json` (`step`,
`n_arrays`, `dtypes`, the per-array crc32 `manifest` and, for `save_tree`,
`extra`), written to a tmp dir and swapped in by rename (the previous step
dir is renamed aside, never deleted first, so a crash mid-swap leaves at
least one complete checkpoint: `_swap` / `_recover`).

Keys are `/`-joined paths of the tree, in the JAX package's leaf order: a
dict by its sorted keys, a list or tuple by index, and a `WeatherState`
under index keys in its flatten order (the sorted fields, `wcon`, the
sorted `tens`, the sorted `stage_tens`). An `nn.Module` of parameters
(`save`'s `params`) is the dict of its `named_parameters()`. bfloat16 is
stored as a `uint16` view with its name in `dtypes`, as the JAX package
stores it, without `ml_dtypes`. Every tensor is copied to the host on the
calling thread before a save goes on, so the caller may update it in
place as soon as the call returns (the port's train step does).

Sharded training state (DTensor leaves, `train/loop.py`'s mesh step) is
gathered whole by a collective on every rank, on the calling thread and
before any writer thread starts; only rank 0 writes, in the same layout,
and every rank waits for the write (`save`, `AsyncSaver.wait`).
`restore(..., mesh=)` places each leaf by the current mesh's rule table
(`parallel/sharding.py`), wherever it was written: one device or any
mesh, bit for bit (the elastic path).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.parallel import sharding as shd
from repro_torch.weather.fields import (WeatherState, field_views,
                                        state_leaves)

_SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (truncated archive,
    bit-flipped array, missing entry). The message names the offending
    entry."""


# numpy-native dtype names; everything else (bfloat16, fp8s) is stored as a
# same-width unsigned-int view + its name in meta.json
_NATIVE = frozenset(
    "bool int8 int16 int32 int64 uint8 uint16 uint32 uint64 "
    "float16 float32 float64 complex64 complex128".split())


def _sharded(params) -> bool:
    return (isinstance(params, nn.Module)
            and any(shd.is_distributed(p) for p in params.parameters()))


def _host(leaf):
    """A leaf as a host array the caller can no longer change: numpy
    arrays as they are (copied), tensors copied to the CPU, synchronously.
    A DTensor is gathered whole (a collective: every rank calls this in
    the same order); ranks other than the writer keep nothing."""
    if shd.is_distributed(leaf):
        leaf = leaf.full_tensor()
        if not shd.is_rank0():
            return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return np.array(leaf)


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _pack(arrays: dict) -> Tuple[dict, dict]:
    """Host leaves as the numpy arrays `np.savez` writes, and the names of
    the dtypes stored as an unsigned-int view."""
    packed, dtypes = {}, {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            name = str(v.dtype).removeprefix("torch.")
            if name in _NATIVE:
                packed[k] = v.numpy()
            else:
                bits = v.view(getattr(torch, f"int{8 * v.element_size()}"))
                packed[k] = bits.numpy().view(
                    np.dtype(f"u{v.element_size()}"))
                dtypes[k] = name
        else:
            packed[k] = v
    return packed, dtypes


def _unpack(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    """One stored array as a CPU tensor of its dtype (a non-native dtype
    from its unsigned-int view, bit for bit; a 0-dim array stays 0-dim)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if not name:
        return torch.from_numpy(arr.copy())
    bits = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
    return torch.from_numpy(bits.copy()).view(getattr(torch, name))


def _manifest(packed: dict) -> dict:
    """Per-array integrity manifest over the PACKED (on-disk) arrays:
    crc32 + byte count + shape + stored dtype for every entry."""
    return {k: {"crc32": zlib.crc32(np.ascontiguousarray(v).tobytes()),
                "nbytes": int(v.nbytes), "shape": list(v.shape),
                "dtype": str(v.dtype)} for k, v in packed.items()}


def _load_verified(base: str) -> Tuple[dict, dict]:
    """Load `base/arrays.npz` + meta, verifying every entry against the
    manifest; returns ({key: CPU tensor}, meta). Raises
    `CheckpointCorruptError` naming the bad entry on a truncated file, an
    unreadable member or a crc32 mismatch; old manifest-less checkpoints
    load unverified (nothing to check against)."""
    meta_path = os.path.join(base, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {base!r}: meta.json is unreadable ({e})") from e
    manifest = meta.get("manifest")
    dtypes = meta.get("dtypes", {})
    flat = {}
    npz = os.path.join(base, "arrays.npz")
    try:
        with np.load(npz) as z:
            for k in list(z.files):
                try:
                    arr = z[k]
                except Exception as e:
                    raise CheckpointCorruptError(
                        f"checkpoint {base!r}: entry {k!r} is unreadable "
                        f"(truncated or bit-flipped archive member: "
                        f"{e})") from e
                if manifest is not None:
                    want = manifest.get(k)
                    if want is None:
                        raise CheckpointCorruptError(
                            f"checkpoint {base!r}: entry {k!r} is not in "
                            f"the manifest (foreign or stale array)")
                    if (not isinstance(want, dict) or "crc32" not in want
                            or "nbytes" not in want):
                        have = (sorted(want) if isinstance(want, dict)
                                else type(want).__name__)
                        raise CheckpointCorruptError(
                            f"checkpoint {base!r}: manifest entry for {k!r} "
                            f"is missing required fields (need crc32 + "
                            f"nbytes, have {have}) — written by an "
                            f"incompatible or corrupted writer; re-save the "
                            f"checkpoint or restore an older step")
                    got_crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                    if (got_crc != want["crc32"]
                            or int(arr.nbytes) != want["nbytes"]):
                        raise CheckpointCorruptError(
                            f"checkpoint {base!r}: entry {k!r} fails "
                            f"integrity check (crc32 {got_crc} != manifest "
                            f"{want['crc32']}) — the array was corrupted "
                            f"on disk")
                flat[k] = _unpack(arr, dtypes.get(k))
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {base!r}: arrays.npz is unreadable (truncated or "
            f"corrupt archive: {e})") from e
    if manifest is not None:
        missing = sorted(set(manifest) - set(flat))
        if missing:
            raise CheckpointCorruptError(
                f"checkpoint {base!r}: manifest entries missing from "
                f"arrays.npz: {missing[:5]}")
    return flat, meta


def _children(node):
    """[(key, child), ...] of an inner node of a tree, in leaf order, or
    None for a leaf."""
    if isinstance(node, nn.Module):
        return [(k, p) for k, p in sorted(node.named_parameters())]
    if isinstance(node, WeatherState):
        return [(str(i), leaf) for i, leaf in enumerate(state_leaves(node))]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _flatten(tree) -> dict:
    """{`/`-joined path: host copy of the leaf}, in leaf order."""
    flat = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            flat[_SEP.join(path)] = _host(node)
            return
        for k, child in kids:
            walk(child, path + [k])

    walk(tree, [])
    return flat


def _unflatten(template, flat: dict, device=None):
    """A tree shaped as `template` from `flat`, each leaf cast to the
    template leaf's dtype. Tensor leaves land on `device` (default: the
    template leaf's device), numpy leaves stay numpy; a state's field,
    tendency and stage dicts come back as views of one field-stacked
    tensor each, in the template's order. An `nn.Module` template has its
    parameters overwritten in place and is returned."""

    def leaf(t, key):
        arr = flat[key]
        if isinstance(t, torch.Tensor):
            dev = t.device if device is None else torch.device(device)
            return arr.to(device=dev, dtype=t.dtype)
        if isinstance(t, np.ndarray):
            return arr.numpy().astype(t.dtype)
        return arr.numpy()

    def state(t: WeatherState, path):
        keys = sorted(t.fields)
        n = len(keys)
        pos = lambda i: _SEP.join(path + [str(i)])

        def group(d, offset):
            names = tuple(d)
            planes = [leaf(d[k], pos(offset + keys.index(k))) for k in names]
            return field_views(torch.stack(planes, dim=-4), names)

        return WeatherState(fields=group(t.fields, 0),
                            wcon=leaf(t.wcon, pos(n)),
                            tens=group(t.tens, n + 1),
                            stage_tens=group(t.stage_tens, 2 * n + 1))

    def walk(node, path):
        if isinstance(node, nn.Module):
            with torch.no_grad():
                for k, p in node.named_parameters():
                    p.copy_(leaf(p, _SEP.join(path + [k])))
            return node
        if isinstance(node, WeatherState):
            return state(node, path)
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)])
                              for i, v in enumerate(node))
        if node is None:
            return None
        return leaf(node, _SEP.join(path))

    return walk(template, [])


def _swap(tmp: str, final: str) -> None:
    """Promote `tmp` to `final` WITHOUT a window where neither exists: the
    previous `final` is renamed aside (rename is atomic on POSIX, rmtree is
    not), the tmp dir takes its place, and only then is the old data
    deleted. A crash at any point leaves `final`, `final + ".old"` or both;
    `_recover` reinstates an orphaned `.old` the next time the directory is
    listed."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def _recover(ckpt_dir: str) -> None:
    """Sweep crash leftovers: a `step_*.old` whose `step_*` is missing or
    incomplete is a swap that died mid-rename — reinstate it; one whose
    final is complete is a swap that died pre-delete — drop it. Stray
    `.tmp` dirs are never touched (they may belong to an in-flight
    writer and are ignored by `all_steps` anyway)."""
    for name in os.listdir(ckpt_dir):
        if not name.endswith(".old") or not _STEP_RE.match(name[:-4]):
            continue
        old = os.path.join(ckpt_dir, name)
        final = old[:-4]
        if os.path.exists(os.path.join(final, "meta.json")):
            shutil.rmtree(old, ignore_errors=True)
        elif os.path.exists(os.path.join(old, "meta.json")):
            if os.path.exists(final):      # incomplete final: lose it
                shutil.rmtree(final, ignore_errors=True)
            os.rename(old, final)


def _write(ckpt_dir: str, step: int, arrays: dict, keep: int,
           meta_more: Optional[dict] = None) -> None:
    """Write one checkpoint of host `arrays` atomically (`meta_more`: more
    keys of meta.json), then keep the newest `keep`."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    packed, dtypes = _pack(arrays)
    np.savez(os.path.join(tmp, "arrays.npz"), **packed)
    meta = {"step": step, "n_arrays": len(arrays), "dtypes": dtypes,
            "manifest": _manifest(packed), **(meta_more or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    _swap(tmp, final)
    _gc(ckpt_dir, keep)


def _train_arrays(params, opt_state) -> dict:
    arrays = {f"params/{k}": v for k, v in _flatten(params).items()}
    arrays.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    return arrays


def save(ckpt_dir: str, step: int, params, opt_state, keep: int = 3):
    """A training checkpoint: `params` under `params/`, `opt_state` under
    `opt/`. Sharded state: every rank calls it; rank 0 writes."""
    arrays = _train_arrays(params, opt_state)
    if shd.is_rank0():
        os.makedirs(ckpt_dir, exist_ok=True)
        _write(ckpt_dir, step, arrays, keep)
    if _sharded(params):
        _barrier()


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


_STEP_RE = re.compile(r"^step_(\d+)$")


def all_steps(ckpt_dir: str):
    """Steps with a COMPLETE checkpoint dir. Strict `step_<digits>`
    matching: stray `step_*.tmp` dirs from a mid-save crash, `.old` dirs
    from a mid-swap crash, and foreign `step_*` junk are ignored (orphaned
    `.old` dirs are first reinstated by the crash-recovery sweep)."""
    if not os.path.isdir(ckpt_dir):
        return []
    _recover(ckpt_dir)
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m is not None:
            meta = os.path.join(ckpt_dir, name, "meta.json")
            if os.path.exists(meta):       # complete checkpoints only
                out.append(int(m.group(1)))
    return sorted(out)                     # os.listdir order is fs-dependent


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, params, opt_state, device=None,
            mesh=None) -> Tuple[Any, Any, int]:
    """A `save` checkpoint onto `params` and `opt_state`, the templates:
    an `nn.Module`'s parameters are overwritten in place; tensor leaves
    land on `device` (default: each template leaf's device). Returns
    (params, opt_state, step).

    With `mesh` (a `DeviceMesh`; every rank calls it) the templates give
    names and dtypes only (full, sharded or meta tensors): each parameter
    becomes a DTensor placed by the current mesh's rule table (kind
    "train"), `m`, `v` and `master` take their parameter's placements and
    `step` is replicated, whatever mesh the checkpoint was written on."""
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat, _ = _load_verified(base)
    p_flat = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    o_flat = {k[len("opt/"):]: v for k, v in flat.items()
              if k.startswith("opt/")}
    if mesh is not None:
        return _restore_on_mesh(mesh, params, opt_state, p_flat, o_flat,
                                step)
    return (_unflatten(params, p_flat, device),
            _unflatten(opt_state, o_flat, device), step)


def _restore_on_mesh(mesh, params, opt_state, p_flat, o_flat, step):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    dev = mesh.device_type
    specs = shd.params_sharding(params, mesh, "train")
    placed = {}
    for name, p in list(params.named_parameters()):
        placed[name] = shd.placements(specs[name], mesh)
        full = p_flat[name].to(device=dev, dtype=p.dtype)
        shd._set_param(params, name,
                       distribute_tensor(full, mesh, placed[name]))
    opt = {k: {n: distribute_tensor(
                   o_flat[f"{k}/{n}"].to(device=dev, dtype=t.dtype), mesh,
                   placed[n])
               for n, t in opt_state[k].items()}
           for k in ("m", "v", "master")}
    # the same value on every rank: replicated as it is (a 0-dim tensor)
    opt["step"] = DTensor.from_local(
        o_flat["step"].to(device=dev, dtype=opt_state["step"].dtype), mesh,
        [Replicate()] * mesh.ndim)
    return params, opt, step


def save_tree(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
              keep: int = 3):
    """Atomic keep-N checkpoint of an arbitrary tree + JSON metadata: the
    arrays land in the npz, `extra` (JSON-serializable; e.g. a serving
    engine's queue and slot bookkeeping) in meta.json. Restore with
    `restore_tree` against a same-structure template."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _write(ckpt_dir, step, _flatten(tree), keep, {"extra": extra})


def restore_tree(ckpt_dir: str, step: int, template, device=None
                 ) -> Tuple[Any, Optional[dict]]:
    """Load a `save_tree` checkpoint: returns `(tree, extra)`. `template`
    supplies the structure and leaf dtypes (a `device="meta"` state costs
    no memory when `device` is given). Every array is verified against the
    crc32 manifest; a truncated or bit-flipped checkpoint raises
    `CheckpointCorruptError` naming the bad entry."""
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat, meta = _load_verified(base)
    return _unflatten(template, flat, device), meta.get("extra")


def read_meta(ckpt_dir: str, step: int) -> dict:
    """The meta.json of one checkpoint (a `save_tree` restore needs the
    `extra` sidecar BEFORE it can build the template). A missing step dir
    raises FileNotFoundError; a present-but-rotten meta.json raises
    `CheckpointCorruptError` naming the file, so callers can fall back to
    an older step."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint meta {path!r} is unreadable ({e}) — the "
            f"checkpoint was torn mid-write or corrupted on disk; restore "
            f"an older step") from e
    if not isinstance(meta, dict):
        raise CheckpointCorruptError(
            f"checkpoint meta {path!r} is not a JSON object "
            f"(got {type(meta).__name__}) — foreign or corrupt file")
    return meta


class AsyncSaver:
    """Overlap checkpoint writes with the next training steps: the tensors
    are copied to the host on the calling thread (complete when `save`
    returns, so an in-place step may follow at once), the file I/O runs
    on a worker thread. A write that failed raises from the next `save`
    or `wait`. Sharded state is gathered on the calling thread of every
    rank (no collective runs in the worker); rank 0's worker writes and
    every rank's `wait` waits for it."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._sharded = False

    def save(self, step: int, params, opt_state):
        self.wait()
        arrays = _train_arrays(params, opt_state)
        self._sharded = _sharded(params)
        if not shd.is_rank0():
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)

        def work():
            try:
                _write(self.ckpt_dir, step, arrays, self.keep)
            except Exception as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
