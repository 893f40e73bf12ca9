"""Reading a device trace, and the per-layer readers over it, on a trace
made by hand (the profiler sees a device only on the card)."""

from __future__ import annotations

import pytest
import torch

from bench import devtrace, harness, manifest
from bench.tests import tiny

ROOT = tiny.ROOT
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CUDA, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a

    def is_hidden_event(self):
        return False


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _self: events})()})()


KERNEL = ("void (anonymous namespace)::dycore_fused_kernel<float>(float "
          "const*, float const*, float*, int)")
ROLL = "void at::native::elementwise_kernel<128, 4>(roll)"


def _trace():
    us = 1000
    events = [
        Event("bench.traced", 0, 100 * us, device=CPU),
        Event("bench.run", 1 * us, 20 * us, device=CPU),
        Event("bench.sync", 20 * us, 95 * us, device=CPU),
        Event("bench.run", 2 * us, 3 * us, device=CUDA, annotation=True),
        Event(ROLL, 10 * us, 14 * us),
        Event(KERNEL, 14 * us, 54 * us),
        Event(ROLL, 56 * us, 60 * us),
        Event(KERNEL, 60 * us, 90 * us),
        Event(KERNEL, 150 * us, 160 * us),          # after the window
    ]
    tr = devtrace.read(Prof(events))
    tr.steps, tr.attempted = 2, 1
    return tr


def test_busy_idle_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(78e-6)
    # 0..10 us inside plan.run, 54..56 and 90..100 waiting on the sync
    assert sorted(tr.gaps) == [pytest.approx((2e-6, "bench.sync")),
                               pytest.approx((10e-6, "bench.run")),
                               pytest.approx((10e-6, "bench.sync"))]
    assert tr.launches("dycore_fused") == pytest.approx([40e-6, 30e-6])
    assert tr.device_s((None,)) == pytest.approx(8e-6)
    assert tr.top_ops(1)[0][0] == KERNEL


def test_kernel_groups_are_whole_names():
    assert devtrace.kernel_group(KERNEL) == "dycore_fused"
    assert devtrace.kernel_group(
        "void (anonymous namespace)::hdiff_stream<float, 1>(float const*, "
        "float*, int, int, int, int, float)") == "hdiff"
    assert devtrace.kernel_group(
        "void (anonymous namespace)::vadvc_stream<float>(float const*)") \
        == "vadvc"
    assert devtrace.kernel_group("void hdiff_stream<float, 2>(x)") == "hdiff"
    assert devtrace.kernel_group(ROLL) is None
    assert devtrace.kernel_group(
        "void at::native::elementwise_kernel<direct_copy_kernel_cuda>(x)") \
        is None


def test_per_layer_readers():
    cell = manifest.cell(ROOT, "nero256.dycore")
    wl = manifest.traffic_kind(cell).Workload(cell, 5, "cpu")
    run = harness.Run(cell=cell, workload=wl, setup_s=5.0,
                      setup_split={}, window={"window_s": 2.0, "steps": 1000,
                                              "forecasts": 5,
                                              "attempted": 5,
                                              "launches": 1000},
                      peak_bytes=5 * 2**30, trace=_trace(), dispatch_s=1e-4)
    read = lambda name: manifest.reader(ROOT, name).read(run)
    assert read("device_idle") == pytest.approx(22.0)
    assert read("lowering.device_ms") == pytest.approx(4e-3)
    assert read("dispatch.launches_per_step") == 1.0
    assert read("dispatch.host_ms") == pytest.approx(0.1)
    bound = wl.step_bound_s()
    assert bound == pytest.approx(0.4207e-3 * wl.members / 4, rel=1e-3)
    assert read("mfu") == pytest.approx(100 * 1000 * bound / 2.0)
    assert read("dycore_fused_roofline") == pytest.approx(100 * bound / 35e-6)
    assert read("hdiff_roofline") is None             # no hdiff launch
    assert read("peak_mem_gib") == 5.0
    run.trace = None
    assert read("device_idle") is None and read("vadvc_roofline") is None
