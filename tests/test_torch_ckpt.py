"""The port's checkpoints against the JAX package's, and `fit`'s resume.

`repro_torch.ckpt.checkpoint` keeps the JAX package's on-disk layout: a
tree saved by either package restores in the other bit for bit, with the
same keys and the same crc32 manifest (a `WeatherState` under index keys
in its flatten order, bf16 as a `uint16` view). Also: the round trip in
fp32 and bf16, keep-N, the manifest against truncation and bit flips, a
legacy checkpoint with no manifest, the swap's crash window, stray
directories, garbled `meta.json`, the async saver's host copy, `fit`
resuming bit for bit (reduced tinyllama on the CPU) and the training
launcher's `--ckpt-dir` / `--ckpt-every`.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as jckpt
from repro.weather import fields as jfields
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.checkpoint import CheckpointCorruptError
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.testing import faults
from repro_torch.train import loop, optim
from repro_torch.weather import convert, dycore, fields

GRID = (3, 8, 8)
DTYPES = ("float32", "bfloat16")


def _tree():
    return {"a": np.arange(512, dtype=np.float32).reshape(4, 128),
            "b": np.full((64,), 2.5, np.float32)}


def _port_state(dtype, seed=0, ensemble=2):
    return fields.initial_state(torch.Generator().manual_seed(seed), GRID,
                                ensemble=ensemble, dtype=dtype, device="cpu")


def _bits(t):
    """A tensor's exact bits as numpy."""
    return convert.tensor_to_numpy(t).view(
        np.uint16 if t.element_size() == 2 else np.uint32)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _port_tree(dtype):
    st = _port_state(dtype)
    return {"lanes": [st], "queue": [fields.initial_state(
        torch.Generator().manual_seed(5), GRID, ensemble=1, dtype=dtype,
        device="cpu")], "x": torch.arange(6, dtype=torch.int32)}


def _template(dtype):
    z = lambda e: fields.zeros_state(GRID, ensemble=e, dtype=dtype,
                                     device="meta")
    return {"lanes": [z(2)], "queue": [z(1)],
            "x": torch.zeros(6, dtype=torch.int32)}


def _assert_states_bit_equal(a, b):
    for part in ("fields", "tens", "stage_tens"):
        for n, t in getattr(a, part).items():
            np.testing.assert_array_equal(_bits(t),
                                          _bits(getattr(b, part)[n]))
    np.testing.assert_array_equal(_bits(a.wcon), _bits(b.wcon))


@pytest.mark.parametrize("dtype", DTYPES)
def test_save_restore_round_trip_is_bit_exact(dtype, tmp_path):
    tree = _port_tree(dtype)
    ckpt.save_tree(str(tmp_path), 3, tree, extra={"k": [1, 2]})
    got, extra = ckpt.restore_tree(str(tmp_path), 3, _template(dtype),
                                   device="cpu")
    assert extra == {"k": [1, 2]}
    for part in ("lanes", "queue"):
        _assert_states_bit_equal(got[part][0], tree[part][0])
        # each dict comes back field-stacked, in the template's order
        assert dycore._stacked_base(
            list(got[part][0].fields.values())) is not None
        assert tuple(got[part][0].fields) == fields.PROGNOSTIC
    assert torch.equal(got["x"], tree["x"])
    meta = ckpt.read_meta(str(tmp_path), 3)
    n = len(fields.PROGNOSTIC)
    assert sorted(meta["manifest"]) == sorted(
        [f"lanes/0/{i}" for i in range(3 * n + 1)]
        + [f"queue/0/{i}" for i in range(3 * n + 1)] + ["x"])
    want_dtypes = ({} if dtype == "float32" else
                   {k: "bfloat16" for k in meta["manifest"] if k != "x"})
    assert meta["dtypes"] == want_dtypes


def test_keep_n_and_latest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        ckpt.save_tree(d, step, _tree(), keep=2)
    assert ckpt.all_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_checkpoint_raises_named_error(tmp_path, mode):
    d = str(tmp_path)
    ckpt.save_tree(d, 0, _tree(), extra=None)
    faults.corrupt_checkpoint(d, 0, mode, seed=3)
    with pytest.raises(CheckpointCorruptError) as ei:
        ckpt.restore_tree(d, 0, _tree())
    msg = str(ei.value)
    assert ("entry" in msg and ("'a'" in msg or "'b'" in msg)) \
        or "arrays.npz" in msg, msg


def test_legacy_checkpoint_without_manifest_still_loads(tmp_path):
    d = str(tmp_path)
    ckpt.save_tree(d, 0, _tree(), extra={"old": True})
    meta_path = os.path.join(d, "step_00000000", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["manifest"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    tree, extra = ckpt.restore_tree(d, 0, _tree())
    assert extra == {"old": True}
    np.testing.assert_array_equal(tree["a"], _tree()["a"])


def test_swap_crash_window_keeps_previous_checkpoint(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save_tree(d, 0, _tree(), extra={"v": 1})
    real_rename = os.rename

    def dying_rename(src, dst):
        if src.endswith(".tmp"):
            raise OSError("simulated crash mid-swap")
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt.os, "rename", dying_rename)
    two = {k: v + 100.0 for k, v in _tree().items()}
    with pytest.raises(OSError, match="mid-swap"):
        ckpt.save_tree(d, 0, two, extra={"v": 2})
    monkeypatch.undo()
    assert ckpt.all_steps(d) == [0]
    tree, extra = ckpt.restore_tree(d, 0, _tree())
    assert extra == {"v": 1}
    np.testing.assert_array_equal(tree["a"], _tree()["a"])


def test_all_steps_ignores_stray_dirs_and_drops_spent_old(tmp_path):
    d = str(tmp_path)
    ckpt.save_tree(d, 3, _tree())
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    os.makedirs(os.path.join(d, "step_abc"))
    os.makedirs(os.path.join(d, "step_00000009"))   # no meta.json: torn
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a checkpoint")
    final = os.path.join(d, "step_00000003")
    shutil.copytree(final, final + ".old")          # swap died pre-delete
    assert ckpt.all_steps(d) == [3]
    assert not os.path.exists(final + ".old")
    assert os.path.isdir(os.path.join(d, "step_00000007.tmp"))


def test_read_meta_on_garbled_json_is_actionable(tmp_path):
    d = str(tmp_path)
    ckpt.save_tree(d, 0, _tree())
    path = os.path.join(d, "step_00000000", "meta.json")
    with open(path, "w") as f:
        f.write('{"step": 0, "manifes')
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        ckpt.read_meta(d, 0)
    with open(path, "w") as f:
        f.write('[1, 2, 3]')
    with pytest.raises(CheckpointCorruptError, match="not a JSON object"):
        ckpt.read_meta(d, 0)
    with pytest.raises(FileNotFoundError):
        ckpt.read_meta(d, 99)


def test_manifest_entry_missing_fields_is_actionable(tmp_path):
    d = str(tmp_path)
    ckpt.save_tree(d, 0, _tree())
    path = os.path.join(d, "step_00000000", "meta.json")
    with open(path) as f:
        meta = json.load(f)
    del meta["manifest"]["a"]["crc32"]
    with open(path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(CheckpointCorruptError,
                       match="'a'.*missing required fields"):
        ckpt.restore_tree(d, 0, _tree())


# ---------------------------------------------------------------------------
# Interchange with the JAX package
# ---------------------------------------------------------------------------


def _jax_tree(dtype):
    st = jfields.initial_state(jax.random.PRNGKey(1), GRID, ensemble=2,
                               dtype=jnp.dtype(dtype))
    q = jfields.initial_state(jax.random.PRNGKey(2), GRID, ensemble=1,
                              dtype=jnp.dtype(dtype))
    return {"lanes": [st], "queue": [q],
            "x": jnp.arange(6, dtype=jnp.int32)}


def _jax_template(dtype):
    z = lambda e: jfields.zeros_state(GRID, ensemble=e,
                                      dtype=jnp.dtype(dtype))
    return {"lanes": [z(2)], "queue": [z(1)],
            "x": jnp.zeros(6, jnp.int32)}


def _same_state(port, js):
    """The port's state equals the JAX package's, bit for bit."""
    for part in ("fields", "tens", "stage_tens"):
        jd = getattr(js, part)
        assert set(getattr(port, part)) == set(jd)
        for n, t in getattr(port, part).items():
            np.testing.assert_array_equal(_bits(t), _jbits(jd[n]))
    np.testing.assert_array_equal(_bits(port.wcon), _jbits(js.wcon))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_checkpoint_restores_in_the_port(dtype, tmp_path):
    d = str(tmp_path)
    jtree = _jax_tree(dtype)
    jckpt.save_tree(d, 0, jtree, extra={"from": "jax"})
    got, extra = ckpt.restore_tree(d, 0, _template(dtype), device="cpu")
    assert extra == {"from": "jax"}
    _same_state(got["lanes"][0], jtree["lanes"][0])
    _same_state(got["queue"][0], jtree["queue"][0])
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(jtree["x"]))
    # the port writes the same keys, dtypes and crc32 manifest
    ckpt.save_tree(str(tmp_path / "port"), 0, got, extra={"from": "jax"})
    want_meta = jckpt.read_meta(d, 0)
    meta = ckpt.read_meta(str(tmp_path / "port"), 0)
    assert meta == want_meta


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_jax(dtype, tmp_path):
    d = str(tmp_path)
    tree = _port_tree(dtype)
    ckpt.save_tree(d, 0, tree, extra={"from": "port"})
    jtree, extra = jckpt.restore_tree(d, 0, _jax_template(dtype))
    assert extra == {"from": "port"}
    _same_state(tree["lanes"][0], jtree["lanes"][0])
    _same_state(tree["queue"][0], jtree["queue"][0])
    jckpt.save_tree(str(tmp_path / "jax"), 0, jtree, extra={"from": "port"})
    assert jckpt.read_meta(str(tmp_path / "jax"), 0) == \
        ckpt.read_meta(d, 0)


# ---------------------------------------------------------------------------
# Training checkpoints and fit's resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.reduced_config(registry.get_config("tinyllama-1.1b"),
                                  layers=1)
    return cfg, api.build(cfg, device="cpu")


def _init(model, seed=0):
    params = model.init(torch.Generator().manual_seed(seed))
    return params, optim.init_opt_state(params)


def test_save_restore_training_state_and_keep_n(tiny, tmp_path):
    _, model = tiny
    params, opt_state = _init(model)
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save(d, step, params, opt_state, keep=2)
    assert ckpt.all_steps(d) == [2, 3]
    names = {f"params/{k}" for k, _ in params.named_parameters()}
    assert names <= set(ckpt.read_meta(d, 3)["manifest"])
    p2, o2 = _init(model, seed=1)
    p2, o2, step = ckpt.restore(d, 3, p2, o2)
    assert step == 3
    for (k, a), (_, b) in zip(params.named_parameters(),
                              p2.named_parameters()):
        assert torch.equal(a, b), k
    for k in opt_state["master"]:
        assert torch.equal(opt_state["master"][k], o2["master"][k])
    assert int(o2["step"]) == int(opt_state["step"])


def test_async_saver_copies_before_returning(tiny, tmp_path):
    """The saver copies every tensor to the host before `save` returns, so
    the in-place train step that follows cannot reach the checkpoint."""
    _, model = tiny
    params, opt_state = _init(model)
    want = {k: p.detach().clone() for k, p in params.named_parameters()}
    saver = ckpt.AsyncSaver(str(tmp_path))
    saver.save(7, params, opt_state)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    p2, o2 = _init(model, seed=1)
    p2, _, _ = ckpt.restore(str(tmp_path), 7, p2, o2)
    for k, p in p2.named_parameters():
        assert torch.equal(p, want[k]), k


def test_async_saver_raises_a_failed_write(tiny, tmp_path, monkeypatch):
    _, model = tiny
    params, opt_state = _init(model)

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    saver = ckpt.AsyncSaver(str(tmp_path))
    saver.save(1, params, opt_state)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()                                 # reported once


def test_fit_resume_reproduces_uninterrupted_run(tiny, tmp_path):
    cfg, model = tiny
    d = str(tmp_path / "ck")
    opt_cfg = optim.OptConfig(lr=1e-3, warmup_steps=0, total_steps=6)

    def run(steps, ckpt_every, ckpt_dir):
        data = synthetic.iterator(cfg, batch=2, seq=16, prefetch=0,
                                  device="cpu")
        return loop.fit(model, data, steps=steps, opt_cfg=opt_cfg,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        log_every=0, log_fn=lambda *_: None)

    p_full, o_full, h_full = run(6, 100, None)           # uninterrupted
    run(3, 3, d)                                         # "crash" at 3
    assert ckpt.all_steps(d) == [3]
    p_res, o_res, h_res = run(6, 100, d)                 # resumes at 3
    assert [h["step"] for h in h_res] == [3, 4, 5]
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[3:]]
    for (k, a), (_, b) in zip(p_full.named_parameters(),
                              p_res.named_parameters()):
        assert torch.equal(a, b), k
    for part in ("m", "v", "master"):
        for k in o_full[part]:
            assert torch.equal(o_full[part][k], o_res[part][k]), (part, k)
    assert int(o_res["step"]) == 6 and ckpt.latest_step(d) == 6


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    base = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", d]
    launch_train.main(base + ["--steps", "3", "--ckpt-every", "2"])
    assert ckpt.all_steps(d) == [2, 3]
    launch_train.main(base + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[fit] resuming from step 3" in out
    assert "over 1 steps on cpu" in out
    assert ckpt.latest_step(d) == 4
    launch_train.main(base + ["--steps", "4"])
    assert "nothing to run" in capsys.readouterr().out
