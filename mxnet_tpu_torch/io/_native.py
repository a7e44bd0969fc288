"""ctypes binding of the native RecordIO engine
(``src/io_native/recordio.cc``): the record writer, the indexed reader and
the prefetch thread that streams batches of records.

The port's copy of ``mxnet_tpu/io/_native.py``, with its signatures. The
library is built at first use by :class:`._cbuild.NativeLib`; a failed
build raises :class:`MXNetError` with the compiler's output, where the
reference's callers fall back to a pure-Python reader.
"""
from __future__ import annotations

import ctypes

from ._cbuild import NativeLib


def _configure(lib):
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rio_writer_write.restype = ctypes.c_int
    lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64]
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_reader_open.restype = ctypes.c_void_p
    lib.rio_reader_open.argtypes = [ctypes.c_char_p]
    lib.rio_reader_count.restype = ctypes.c_uint64
    lib.rio_reader_count.argtypes = [ctypes.c_void_p]
    lib.rio_reader_size.restype = ctypes.c_uint32
    lib.rio_reader_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rio_reader_offset.restype = ctypes.c_uint64
    lib.rio_reader_offset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rio_reader_get.restype = ctypes.c_int
    lib.rio_reader_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
    lib.rio_reader_free.argtypes = [ctypes.c_void_p]
    lib.rio_prefetch_create.restype = ctypes.c_void_p
    lib.rio_prefetch_create.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_uint64]
    lib.rio_prefetch_next.restype = ctypes.c_int64
    lib.rio_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.rio_prefetch_release.argtypes = [ctypes.c_void_p]
    lib.rio_prefetch_free.argtypes = [ctypes.c_void_p]


_NATIVE = NativeLib("recordio.cc", "native RecordIO engine", _configure)


def get_lib():
    """The RecordIO library, built on first use; raises
    :class:`MXNetError` when the source is missing or does not build."""
    return _NATIVE.get()
