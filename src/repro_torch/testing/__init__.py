"""repro_torch.testing: deterministic fault injection for chaos tests.

`faults` is the seedable fault-injection harness the supervised forecast
service (`serve/forecast.py`) consults — NaN/Inf slot poisoning, simulated
compile failures, mid-round device loss, stragglers, wire corruption — and
the checkpoint file corruption helpers.
"""

from repro_torch.testing.faults import (FaultInjector, FaultSpec,
                                        InjectedCompileError,
                                        InjectedDeviceLoss, InjectedFault,
                                        bitflip_file, corrupt_checkpoint,
                                        truncate_file)

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault",
           "InjectedCompileError", "InjectedDeviceLoss", "bitflip_file",
           "corrupt_checkpoint", "truncate_file"]
