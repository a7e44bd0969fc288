"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source in ``mxnet_tpu_torch/csrc/`` is compiled on its own, for
``sm_90a``, into a shared library with a plain C interface, at first use,
into ``mxnet_tpu_torch/_build/`` (listed in ``.gitignore``); one source may
hold several kernels, each with its own C entry point. A library's file
name carries a digest of its source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Several
sources build in parallel: one ``nvcc`` per source, all started together.
A flash kernel's instances live in a header and build from three sources,
one a group of element dtypes (``flash_fwd``, ``flash_fwd_f16``,
``flash_fwd_f8``, ...), so that they compile in parallel.

:func:`compile_source` builds CUDA C given at run time (``rtc.CudaModule``)
the same way, cached by a digest of the text and the flags.

Nothing here runs at import time, so ``import mxnet_tpu_torch`` works on a
machine without ``nvcc`` or a GPU; a wrapper that launches a kernel on a
CUDA tensor calls :func:`load`, which raises :class:`MXNetError` when the
kernel cannot be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "nvcc_command",
           "compile_source"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# kernel name -> (source file, C symbol, ctypes argtypes)
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_FWD = [_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _I, _P]
_DKV = [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _I, _P]
_DQ = [_P] * 9 + [_I] * 5 + [_F, _I, _I, _I, _I, _P]
SOURCES = {
    # each flash kernel: float32 and bfloat16; float16 (_f16); fp8 (_f8)
    "flash_fwd": ("flash_fwd.cu", "mxtt_flash_fwd", _FWD),
    "flash_fwd_f16": ("flash_fwd_f16.cu", "mxtt_flash_fwd", _FWD),
    "flash_fwd_f8": ("flash_fwd_f8.cu", "mxtt_flash_fwd", _FWD),
    "flash_bwd_dkv": ("flash_bwd.cu", "mxtt_flash_bwd_dkv", _DKV),
    "flash_bwd_dkv_f16": ("flash_bwd_f16.cu", "mxtt_flash_bwd_dkv", _DKV),
    "flash_bwd_dkv_f8": ("flash_bwd_f8.cu", "mxtt_flash_bwd_dkv", _DKV),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "mxtt_flash_bwd_dq", _DQ),
    "flash_bwd_dq_f16": ("flash_bwd_dq_f16.cu", "mxtt_flash_bwd_dq", _DQ),
    "flash_bwd_dq_f8": ("flash_bwd_dq_f8.cu", "mxtt_flash_bwd_dq", _DQ),
    "layer_norm": ("layer_norm.cu", "mxtt_layer_norm_fwd",
                   [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _P]),
    "softmax": ("softmax.cu", "mxtt_softmax_fwd",
                [_P, _P, _LL, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_funcs = {}
# (name, command, seconds, ptxas report) of every build in this process
build_log = []


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise MXNetError(
        "cannot build the CUDA kernels: nvcc not found (set CUDA_HOME or "
        "put nvcc on PATH)")


def _lib_path(name):
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha256()
    for p in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(name, out=None):
    """The nvcc command line that builds the source of kernel ``name``."""
    out = out or _lib_path(name)
    return [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(CSRC / SOURCES[name][0])]


def _build_missing(names):
    # one build per source, named after its first kernel
    todo = {}
    for n in names:
        todo.setdefault(SOURCES[n][0], n)
    todo = [n for n in todo.values() if not _lib_path(n).is_file()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        final = _lib_path(n)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = nvcc_command(n, tmp)
        procs.append((n, cmd, tmp, final, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, cmd, tmp, final, t0, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}: {' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, final)
        build_log.append((n, cmd, secs, log))
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(names=None):
    """Compile every named kernel (default: all) that is not built yet;
    returns ``{name: library path}``."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        _build_missing(names)
    return {n: _lib_path(n) for n in names}


def load(name):
    """The C entry point of kernel ``name``, built first if needed, with
    its ``argtypes``/``restype`` declared."""
    fn = _funcs.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _funcs:
            _build_missing([name])
            _, symbol, argtypes = SOURCES[name]
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _funcs[name] = fn
    return _funcs[name]


def compile_source(text, stem, options=()):
    """Compile the CUDA C ``text`` into a shared library with the kernels'
    flags (plus ``options``) and return its path. The file name carries a
    digest of the text and the flags, so a text built before is loaded as
    it is. A failed compile raises :class:`MXNetError` with nvcc's log."""
    flags = ARCH_FLAGS + NVCC_FLAGS + tuple(options)
    h = hashlib.sha256(text.encode())
    h.update("\0".join(flags).encode())
    final = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    with _lock:
        if final.is_file():
            return final
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = final.with_suffix(".cu")
        src.write_text(text)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise MXNetError(
                f"CUDA compile of {stem} failed: {' '.join(cmd)}\n"
                f"{proc.stdout}")
        os.replace(tmp, final)
        build_log.append((stem, cmd, time.perf_counter() - t0, proc.stdout))
    return final
