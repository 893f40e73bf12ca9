"""Forecast-as-a-service demo of the PyTorch/CUDA port: concurrent requests
through `ForecastEngine`.

Submits a mix of forecast requests — different stencil programs, member
initial conditions, step counts, precisions — to one engine on the card
(`--device cpu`: the kernels' plain versions). The engine compiles each
distinct program ONCE (plan cache), folds admitted requests into the
ensemble axis of the shared plan (continuous batching), retires each
request at the round boundary where its step count completes, and
backfills the freed slot from the queue. Every served result is
bit-identical to a solo `compile(program).run(state, steps)`.

`--chaos` turns on the supervision demo (docs/torch_robustness.md): a NaN
poison and a transient device loss are injected mid-run; the engine
quarantines the poisoned request (with a per-field diagnosis), retries
through the device loss, and serves everyone else bit-identically.

`--kill-device N` runs the mesh-failover drill instead: the engine
serves on a 2x2 mesh, logical device N dies *persistently* at round 1,
and the engine rebuilds a mesh from the survivors, reshards, and
finishes every in-flight request — printed as a before/after mesh line
and a preserved-request table with a bit-for-bit check against a solo
run on the original mesh. Where the machine has fewer than 4 cards, the
mesh lists the card once a shard (`["cuda:0"] * 4`: four logical
devices on one card) and says so.

Run:  PYTHONPATH=src python examples/torch_forecast_service.py
      PYTHONPATH=src python examples/torch_forecast_service.py \\
          --slots 4 --requests 10 --ckpt build/forecast_ckpt
      PYTHONPATH=src python examples/torch_forecast_service.py --chaos
      PYTHONPATH=src python examples/torch_forecast_service.py --kill-device 3
"""

import argparse

import torch

from repro_torch.kernels._build import print_launches
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.forecast import ForecastEngine, ForecastRequest
from repro_torch.testing.faults import FaultInjector, FaultSpec
from repro_torch.weather import domain, fields
from repro_torch.weather import program as wprog
from repro_torch.weather.program import StencilProgram


def request_state(i: int, prog: StencilProgram, dev: torch.device):
    """Request `i`'s single-member initial state, drawn from seed `i`."""
    return fields.initial_state(torch.Generator().manual_seed(i),
                                prog.grid_shape, ensemble=1,
                                dtype=prog.dtype, device=dev)


def kill_device_demo(args, dev: torch.device):
    """Mesh-failover drill: persistent device loss mid-flight."""
    have = torch.cuda.device_count() if dev.type == "cuda" else 0
    devices = None
    if have < 4:
        devices = [dev] * 4
        print(f"mesh (2, 2): 4 shards on {max(have, 1)} {dev.type} "
              f"device(s); listing {dev} 4 times (4 logical devices)")
    mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
    inj = FaultInjector([FaultSpec(kind="device_loss", round=1,
                                   device=args.kill_device, once=False)],
                        seed=0)
    eng = ForecastEngine(slots=args.slots, mesh=mesh, ax_y="data",
                         ax_x="model", fault_injector=inj)
    catalog = (StencilProgram(grid_shape=(4, 16, 16), op="dycore"),
               StencilProgram(grid_shape=(3, 8, 8), op="hdiff"))
    print(f"== mesh-failover drill: device {args.kill_device} dies "
          f"persistently at round 1, {args.requests} requests in flight ==")
    print(f"before: mesh 2x2 on devices {list(mesh.ids)} "
          f"({', '.join(str(d) for d in mesh.device_list)})")
    inputs = {}
    for i in range(args.requests):
        prog = catalog[i % len(catalog)]
        state = request_state(i, prog, dev)
        rid = eng.submit(ForecastRequest(program=prog, state=state,
                                         steps=3 + 2 * (i % 2)))
        inputs[rid] = (prog, state)

    results = eng.drain()
    s = eng.stats()
    fo = s["failovers"][0] if s["failovers"] else None
    if fo is None:
        print("no failover happened — was the device id on the mesh?")
    else:
        print(f"after:  mesh {fo['to_shape'][0]}x{fo['to_shape'][1]} on "
              f"devices {fo['to_devices']} (lost device "
              f"{fo['lost_device']} at round {fo['round']}, reshard "
              f"{fo['reshard_ms']:.1f} ms)")
    print(f"{'rid':>3} {'op':>6} {'steps':>5} {'rounds':>6} "
          f"{'status':>6} {'bits_vs_original_mesh':>22}")
    preserved = 0
    for rid in sorted(results):
        r, (prog, state) = results[rid], inputs[rid]
        want = domain.gather_state(wprog.compile(
            prog, mesh=mesh, ax_y="data", ax_x="model").run(state, r.steps))
        same = r.ok and all(
            torch.equal(r.state.fields[n], want.fields[n])
            for n in prog.fields)
        preserved += same
        print(f"{rid:>3} {prog.op:>6} {r.steps:>5} {r.rounds:>6} "
              f"{r.status:>6} {'identical' if same else 'DIVERGED':>22}")
        assert same, f"rid={rid} not preserved bit-for-bit"
    print(f"stats: mesh_failovers={s['mesh_failovers']} "
          f"recovery_rounds={s['recovery_rounds']} "
          f"requests_preserved={s['requests_preserved']} "
          f"lane_failures={s['lane_failures']}")
    assert fo is not None
    print(f"bit for bit: {preserved} of {len(results)} requests identical "
          f"to their solo runs on the original mesh")
    print_launches()
    print("mesh-failover drill OK")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slots", type=int, default=2,
                    help="ensemble slots per cached plan")
    ap.add_argument("--requests", type=int, default=6,
                    help="number of forecast requests to submit")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir: snapshot the warm engine mid-"
                         "drain and finish from the restored engine")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a NaN poison + a transient device loss "
                         "and show quarantine/retry in action")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded queue: submit() raises QueueFullError "
                         "past this (backpressure)")
    ap.add_argument("--kill-device", type=int, default=None, metavar="N",
                    help="mesh-failover drill: serve on a 2x2 mesh, kill "
                         "device N persistently at round 1, show the "
                         "before/after mesh and the preserved requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    if args.kill_device is not None:
        kill_device_demo(args, dev)
        return

    inj = None
    if args.chaos:
        inj = FaultInjector([FaultSpec(kind="poison_nan", round=1),
                             FaultSpec(kind="device_loss", round=2)],
                            seed=0)

    catalog = (
        StencilProgram(grid_shape=(4, 16, 16), op="dycore"),
        StencilProgram(grid_shape=(4, 16, 16), op="dycore",
                       dtype="bfloat16"),
        StencilProgram(grid_shape=(3, 8, 8), op="hdiff"),
    )
    eng = ForecastEngine(slots=args.slots, device=dev, ckpt_dir=args.ckpt,
                         max_queue=args.max_queue, fault_injector=inj)
    print(f"== forecast service: {args.requests} requests over "
          f"{len(catalog)} programs, {args.slots} slots, device {dev} ==")
    for i in range(args.requests):
        prog = catalog[i % len(catalog)]
        state = request_state(i, prog, dev)
        rid = eng.submit(ForecastRequest(program=prog, state=state,
                                         steps=2 + 3 * (i % 3)))
        print(f"submitted rid={rid} op={prog.op} dtype={prog.dtype} "
              f"steps={2 + 3 * (i % 3)}")

    if args.ckpt:
        # a few scheduler beats, then snapshot + restore the warm engine:
        # in-flight lane batches, queue, and finished results all survive
        eng.pump()
        step = eng.checkpoint()
        print(f"checkpointed warm engine at step {step} -> {args.ckpt}")
        eng = ForecastEngine.restore(args.ckpt, device=dev)
        print(f"restored: {eng.stats()['active']} active, "
              f"{eng.stats()['queued']} queued")

    results = eng.drain()
    print(f"{'rid':>3} {'op':>6} {'dtype':>8} {'steps':>5} "
          f"{'rounds':>6} {'wait_ms':>8} {'latency_ms':>10} {'status':>8}")
    for rid in sorted(results):
        r = results[rid]
        print(f"{rid:>3} {r.program.op:>6} {r.program.dtype:>8} "
              f"{r.steps:>5} {r.rounds:>6} {r.queue_wait_s * 1e3:>8.1f} "
              f"{r.latency_s * 1e3:>10.1f} {r.status:>8}")
        if r.diagnosis is not None:
            print(f"     diagnosis: {r.diagnosis.get('reason')} "
                  f"{r.diagnosis.get('bad_leaves', '')}")
    s = eng.stats()
    print(f"stats: plans_cached={s['plans_cached']} "
          f"cache_hit_rate={s['plan_cache_hit_rate']:.2f} "
          f"occupancy={s['occupancy']:.2f} rounds={s['rounds']} "
          f"rolled_back={s['rolled_back_slot_rounds']}")
    if args.chaos:
        print(f"chaos: faults_fired={inj.fired()} "
              f"quarantined={s['quarantined']} "
              f"round_retries={s['round_retries']} "
              f"failed={s['failed']}")
    print_launches()
    print("forecast service OK")


if __name__ == "__main__":
    main()
