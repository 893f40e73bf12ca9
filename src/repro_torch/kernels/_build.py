"""Build and load the CUDA kernels of `src/repro_torch/csrc/`.

At first use, `nvcc` compiles each `.cu` source to an object for sm_90a, all
sources at once in parallel processes, and links the objects into one shared
library with a plain C interface, which `ctypes` loads. Every source is
compiled with `-fmad=false`, so that each stencil rounds bit for bit as its
plain version, except those in `FMAD_SOURCES`: the cross-entropy kernels and
the bf16 flash-attention kernel are held to their plain versions within a
tolerance, and fused multiply-adds double the rate of the fp32 product and
shorten the softmax. The build goes to
`build/repro_torch_kernels/<hash of sources and flags>/` under the repository
root and is reused while the sources stay the same, with each source's
ptxas report (registers, spills) beside it in `ptxas.json`. Nothing here
runs when the module is imported.

Every kernel wrapper counts its launches in `LAUNCHES` (one per launch, and
nowhere else), so a run can show which kernels its path went through, and
runs inside the span `nero.kernel.<its LAUNCHES key>` (`core/spans.py`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("hdiff.cu", "vadvc.cu", "dycore_fused.cu", "dycore_kstep.cu",
           "hadv.cu", "copy.cu", "flash_attn.cu", "flash_attn_tc.cu",
           "lru_scan.cu", "xent.cu", "xent_tc.cu", "slot_guard.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
# built with -fmad=true in place of -fmad=false
FMAD_SOURCES = ("xent.cu", "flash_attn_tc.cu", "xent_tc.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "nero_hdiff": (_P, _P, _LL, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "nero_vadvc": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                   _P),
    "nero_dycore_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I,
                          _I, _F, _F, _I, _I, _I, _P),
    "nero_dycore_kstep": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F,
                          _F, _I, _I, _I, _I, _I, _I, _P),
    "nero_hdiff_kstep": (_P, _P, _LL, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "nero_hadv": (_P, _P, _LL, _I, _I, _F, _I, _I, _I, _I, _P),
    "nero_copy": (_P, _P, _LL, _P),
    "nero_flash_attn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                        _LL, _LL, _I, _I, _F, _F, _P),
    "nero_flash_attn_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                           _LL, _LL, _I, _I, _F, _F, _P),
    "nero_lru_scan": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nero_xent": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  _LL, _LL, _LL, _F, _I, _I, _P),
    "nero_xent_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _LL, _LL, _LL, _F, _I, _I, _P),
    "nero_slot_guard": (_P, _I, _I, _I, _I, _I, _I, _I, _LL, _P, _P, _P,
                        _P),
    "nero_slot_guard_partial": (_P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL,
                                _P, _P),
    "nero_slot_guard_finish": (_P, _I, _I, _I, _LL, _P, _P, _P),
}

LAUNCHES: Dict[str, int] = {"hdiff": 0, "vadvc": 0, "dycore_fused": 0,
                             "dycore_kstep": 0, "hdiff_kstep": 0, "hadv": 0,
                             "copy": 0, "flash_attn": 0, "lru_scan": 0,
                             "xent": 0, "slot_guard": 0}

_lib: Optional[ctypes.CDLL] = None
build_log: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def print_launches() -> None:
    """Print this process's launches so far (`LAUNCHES`, the kernels
    launched at least once) as one line, `kernel launches: {json}`."""
    print("kernel launches: "
          + json.dumps({k: n for k, n in LAUNCHES.items() if n}))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def flags(src: str) -> tuple:
    """The nvcc flags of one source."""
    if src in FMAD_SOURCES:
        return tuple("-fmad=true" if f == "-fmad=false" else f
                     for f in NVCC_FLAGS)
    return NVCC_FLAGS


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(FMAD_SOURCES).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Dict[str, str]:
    """Compile every source in parallel, then link; returns ptxas reports."""
    nvcc = _nvcc()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        procs[src] = subprocess.Popen(
            [nvcc, *flags(src), "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports, failed = {}, []
    for src, p in procs.items():
        out, _ = p.communicate()
        reports[src] = out
        if p.returncode:
            failed.append(f"{src} (exit {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = tmp / "libnero_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib),
         *(str(tmp / (Path(s).stem + ".o")) for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (tmp / "ptxas.json").write_text(json.dumps(reports))
    os.replace(tmp / "ptxas.json", out_dir / "ptxas.json")
    os.replace(lib, out_dir / "libnero_kernels.so")
    shutil.rmtree(tmp, ignore_errors=True)
    return reports


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (once per process)."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "libnero_kernels.so"
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # one build at a time per directory
        try:
            built = not so.exists()
            saved = out_dir / "ptxas.json"
            reports = (_compile(out_dir) if built else
                       json.loads(saved.read_text()) if saved.exists()
                       else {})
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_log.update(seconds=time.perf_counter() - t0, path=str(so),
                     built=built, ptxas=reports)
    _lib = lib
    return lib


def check_operand(kernel: str, name: str, t, shape, dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `shape` and `dtype`
    (float32 or bfloat16)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} dtype {t.dtype}; expected "
                         f"{dtype} (float32 or bfloat16)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)}; "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on `t`'s device (read without
    building a `torch.cuda.Stream`, which costs microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
