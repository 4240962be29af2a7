"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``.cu`` file has a plain C interface (``extern "C"`` launchers taking
pointers, sizes, strides, a dtype code and the stream) and includes no
PyTorch header, so one nvcc call takes seconds.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source and the flags: an edited source is rebuilt, an unchanged one is
loaded as it is.  Nothing is built when a module is imported, only on the
first launch (or by :func:`build_all`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "quant_matmul",
           "ssd_step", "rms_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of each library's launchers, in the order of their C signatures
_SIGNATURES = {
    "flash_attention": {"flash_attention_launch":
                        [_ptr] * 4 + [_int] * 6 + [_i64] * 12
                        + [ctypes.c_float, _int, _int, _ptr]},
    "decode_attention": {"decode_attention_launch":
                         [_ptr] * 5 + [_int] * 6 + [_i64] * 10
                         + [ctypes.c_float, _int, _ptr],
                         "decode_attention_partial_launch":
                         [_ptr] * 6 + [_int] * 6 + [_i64] * 10
                         + [ctypes.c_float, _int, _ptr]},
    "ssd_scan": {"ssd_scan_launch":
                 [_ptr] * 9 + [_int] * 6 + [_i64] * 12 + [_ptr]},
    "quant_matmul": {"quant_matmul_launch":
                     [_ptr] * 6 + [_int] * 3 + [_i64] * 3 + [_int] * 3
                     + [_ptr]},
    "ssd_step": {"ssd_step_launch": [_ptr] * 9 + [_int] * 4 + [_ptr]},
    "rms_norm": {"rms_norm_launch":
                 [_ptr, _i64, _int] * 2 + [_ptr, _int] * 2 + [_int] * 4
                 + [ctypes.c_float, _ptr]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_sm_counts: Dict[int, int] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together.  Returns each compiler's output
    (``-Xptxas -v``: registers, shared memory, spills per kernel); a
    library that was already built maps to ``""``.  Raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent builder loads either copy
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use.  Once loaded,
    a launch finds it without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (a ``torch.device``), cached."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg: Optional[bytes] = getattr(library(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({(msg or b'').decode()})")
