"""Build and load the framework-neutral native IO engines
(``src/io_native/*.cc``).

The port's copy of ``mxnet_tpu/io/_cbuild.py``: a source is compiled with
the host's C++ compiler (``CXX``, default ``g++``) at first use into
``mxnet_tpu_torch/_build/``, named by a digest of the source and written
under a temporary name and renamed, so processes building at once do not
race, then loaded with ctypes. Where the reference returns None so that
its callers take a pure-Python path, a missing source or a failed build
raises :class:`MXNetError` here, with the compiler's output: there is no
silent fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

_SRC_DIR = Path(__file__).resolve().parents[2] / "src" / "io_native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


class NativeLib:
    """One native library: built on the first :meth:`get`, then cached."""

    def __init__(self, src_name: str, what: str, configure):
        self._src = _SRC_DIR / src_name
        self._what = what
        self._configure = configure
        self._lock = threading.Lock()
        self._lib = None

    def get(self):
        """The loaded library; raises :class:`MXNetError` when the source
        is missing or does not build."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if not self._src.exists():
                raise MXNetError(f"{self._what} source {self._src} is "
                                 "missing")
            digest = hashlib.sha256(self._src.read_bytes()).hexdigest()[:16]
            so = _BUILD_DIR / f"{self._src.stem}-{digest}.so"
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                cxx = os.environ.get("CXX", "g++")
                try:
                    res = subprocess.run([cxx, *_FLAGS, "-o", str(tmp),
                                          str(self._src)],
                                         capture_output=True, text=True,
                                         timeout=300)
                except (OSError, subprocess.SubprocessError) as e:
                    raise MXNetError(f"building the {self._what} with "
                                     f"{cxx} failed: {e}") from e
                if res.returncode != 0:
                    raise MXNetError(f"building the {self._what} with "
                                     f"{cxx} failed:\n{res.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._configure(lib)
            self._lib = lib
            return lib
