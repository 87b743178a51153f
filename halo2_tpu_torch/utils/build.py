"""Build, load and launch the CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
`_build/lib<name>.so`, a shared library with a plain C interface that is
loaded with `ctypes`.  Nothing here includes PyTorch's headers, so a build
takes seconds.  The build happens at first use (or ahead of time, all
sources in parallel, through `build_all`), never at import.  `launch`
calls an entry point on a device's current stream.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

SOURCES = ("field_kernels", "point_kernels", "dft_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
               for f in os.listdir(CSRC_DIR))


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _lib_path(name) + f".tmp.{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.h2_tmp = tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.h2_tmp, _lib_path(name))
    return log


def ptxas_usage(log: str) -> dict:
    """{function: {"registers": int, "stack_bytes": int}} from the
    `-Xptxas -v` lines of an nvcc log, by mangled name (a device function
    that is not inlined has its own stack frame and no registers line)."""
    out, fn, props = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
            out[fn] = {}
        elif "Function properties for" in line:
            props = line.split("Function properties for", 1)[1].strip()
        elif props and "bytes stack frame" in line:
            out.setdefault(props, {})["stack_bytes"] = int(line.split()[0])
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used", 1)[1].split()[0])
    return out


def build_all() -> dict:
    """Compile every stale source, all `nvcc` processes started together.
    Returns {"seconds": wall time, "logs": {name: compiler output}}."""
    t0 = time.time()
    procs = {name: _start(name) for name in SOURCES if _stale(name)}
    logs = {name: _finish(name, proc) for name, proc in procs.items()}
    return {"seconds": time.time() - t0, "logs": logs}


def launch(device: torch.device, fn, *args) -> None:
    """fn(*args, stream) with `device` the current CUDA device and its
    current stream (the capturing stream inside a CUDA graph).  The stream
    is read on every call, never cached; the device switch is skipped when
    `device` is already current.  Raises on the error code fn returns."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{err}")


def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
        if _stale(name):
            _finish(name, _start(name))
        lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib
