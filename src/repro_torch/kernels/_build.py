"""Build, load and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface under ``build/repro_torch/`` at the repository
root, at first use, and loaded with ``ctypes``.  No PyTorch header is
included, so a build takes seconds.  Flags: ``sm_90a``, ``-O3``, no fast
math; ``-fmad=false`` for the sources in ``EXACT_FMA``, whose results must
round as the plain PyTorch version's separate tensor ops do (the UCT scores,
or argmax decisions flip on near ties; the backups and the recurrent
states, held bit-equal).  The attention sources and the chunked scans are
built with contraction into FMAs: their checks allow for the order of the
sums.

``build_all()`` compiles every source at once, one ``nvcc`` process per
source.  A library is rebuilt when a source it depends on is newer.  Builds
hold a thread lock and an ``fcntl`` lock on ``BUILD_DIR/build.lock``, so
that the ranks of a multi-process job that build at first use do not race
(the kernel releases the file lock when a process dies).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("uct_select", "search_wave", "flash_attention",
           "flash_attention_bwd", "decode_attention", "rwkv6_scan",
           "ssm_scan", "rwkv6_chunk", "ssm_chunk", "rwkv6_chunk_bwd",
           "ssm_chunk_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
EXACT_FMA = ("uct_select", "search_wave", "rwkv6_scan", "ssm_scan")
DEFINES: List[str] = []      # set by ``use_defines`` only

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def flags(name: str) -> List[str]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return (NVCC_FLAGS + (["-fmad=false"] if name in EXACT_FMA else [])
            + DEFINES)


def use_defines(defines: List[str], build_dir: Path) -> None:
    """Build every library from here on with the extra nvcc ``defines``
    into ``build_dir``, apart from the normal build: a diagnostic build
    (``kernels/chunk_phases.py``).  Only before the first load."""
    global BUILD_DIR, DEFINES
    if _libs:
        raise RuntimeError("use_defines comes before the first load")
    BUILD_DIR, DEFINES = Path(build_dir), list(defines)


@contextlib.contextmanager
def _locked():
    """This thread and process alone build into ``BUILD_DIR``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(proc.tmp, _lib_path(name))
    return out


def build_all(force: bool = False) -> Dict[str, str]:
    """Compile every stale source in parallel; returns ``{name: nvcc log}``
    for the sources built."""
    with _locked():
        names: List[str] = [s for s in SOURCES if force or _stale(s)]
        procs = {s: _start(s) for s in names}
        return {s: _finish(s, p) for s, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built when stale)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locked():
        if name not in _libs:
            if _stale(name):
                proc = _start(name)
                _finish(name, proc)
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``csrc/<name>.cu``, returning a
    ``cudaError_t`` as int; declared once and cached."""
    f = _fns.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return f


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def resolve_impl(impl, t: torch.Tensor) -> str:
    """"cuda" for CUDA tensors, "ref" for CPU ones; an explicit "cuda"
    request on CPU tensors raises."""
    if impl is None:
        return "cuda" if t.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors, got "
                         f"{t.device}")
    return impl


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would need a gradient through a kernel that has
    no backward: its ``ctypes`` launch writes into a fresh tensor with no
    ``grad_fn``, so the gradient would be cut without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad")


def packed(t: torch.Tensor, k: int) -> bool:
    """Whether the last ``k`` dims of ``t`` are packed (size-1 dims take
    any stride)."""
    want = 1
    for d in range(t.dim() - 1, t.dim() - 1 - k, -1):
        if t.shape[d] != 1 and t.stride(d) != want:
            return False
        want *= t.shape[d]
    return True


def check_operand(t: torch.Tensor, name: str, dtype, shape, device,
                  packed_trailing: Optional[int] = None):
    """Right device, dtype and shape, and contiguous; with
    ``packed_trailing=k`` only the last ``k`` dims need be packed (the
    kernel reads the leading ones through their strides)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if packed_trailing is None:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    elif not packed(t, packed_trailing):
        raise ValueError(f"{name} needs packed trailing dims, got strides "
                         f"{t.stride()}")
