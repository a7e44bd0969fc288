"""ctypes binding of the native text parsers (``src/io_native/textparse.cc``).

The port's copy of ``mxnet_tpu/io/_textparse.py``: the framework-neutral
C++ source beside the two packages is built at first use by
:class:`._cbuild.NativeLib`, whose failed build raises
:class:`MXNetError` with the compiler's output: there is no silent
fallback. The strict numpy parse runs only where the native
scanner rejects the input (a ragged row, a token that is not a number),
and reports the error as numpy does.

``counts()`` gives how many files each path parsed in this process.
"""
from __future__ import annotations

import ctypes

import numpy as onp

from ._cbuild import NativeLib

_counts = {"libsvm_native": 0, "libsvm_numpy": 0, "csv_native": 0,
           "csv_numpy": 0}


def counts():
    """Files parsed in this process, by format and path (``native`` or the
    strict ``numpy`` one)."""
    return dict(_counts)


def _configure(lib):
    lib.tp_csv_parse.restype = ctypes.POINTER(ctypes.c_float)
    lib.tp_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.tp_libsvm_parse.restype = ctypes.c_int
    lib.tp_libsvm_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.tp_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.tp_free_i64.argtypes = [ctypes.POINTER(ctypes.c_int64)]


_NATIVE = NativeLib("textparse.cc", "native text parser", _configure)


def get_lib():
    """The parser library, built on first use; raises :class:`MXNetError`
    when the source is missing or does not build."""
    return _NATIVE.get()


def parse_csv(path: str, delimiter: str = ",") -> onp.ndarray:
    """A CSV of floats as a (rows, cols) float32 array, by the threaded
    native scanner; input it rejects goes to the strict numpy parse."""
    lib = get_lib()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    buf = lib.tp_csv_parse(path.encode(), delimiter.encode(),
                           ctypes.byref(rows), ctypes.byref(cols))
    if buf:
        n = rows.value * cols.value
        out = onp.ctypeslib.as_array(buf, shape=(n,)).astype(
            "float32", copy=True).reshape(rows.value, cols.value)
        lib.tp_free(buf)
        _counts["csv_native"] += 1
        return out
    _counts["csv_numpy"] += 1
    return onp.loadtxt(path, delimiter=delimiter, dtype="float32", ndmin=2)


def parse_libsvm(path: str):
    """LibSVM text as (labels, indptr, indices, values): the CSR triple and
    the labels, by the native scanner; input it rejects goes to the numpy
    parse."""
    lib = get_lib()
    nrows, nnz = ctypes.c_int64(), ctypes.c_int64()
    indptr = ctypes.POINTER(ctypes.c_int64)()
    indices = ctypes.POINTER(ctypes.c_int64)()
    values = ctypes.POINTER(ctypes.c_float)()
    labels = ctypes.POINTER(ctypes.c_float)()
    rc = lib.tp_libsvm_parse(path.encode(), ctypes.byref(nrows),
                             ctypes.byref(nnz), ctypes.byref(indptr),
                             ctypes.byref(indices), ctypes.byref(values),
                             ctypes.byref(labels))
    if rc == 0:
        n, z = nrows.value, nnz.value
        ip = onp.ctypeslib.as_array(indptr, shape=(n + 1,)).astype(
            "int64", copy=True)
        ix = onp.ctypeslib.as_array(
            indices, shape=(max(1, z),))[:z].astype("int64", copy=True)
        vs = onp.ctypeslib.as_array(
            values, shape=(max(1, z),))[:z].astype("float32", copy=True)
        lb = onp.ctypeslib.as_array(
            labels, shape=(max(1, n),))[:n].astype("float32", copy=True)
        lib.tp_free_i64(indptr)
        lib.tp_free_i64(indices)
        lib.tp_free(values)
        lib.tp_free(labels)
        _counts["libsvm_native"] += 1
        return lb, ip, ix, vs
    _counts["libsvm_numpy"] += 1
    labels, ip, ix, vs = [], [0], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                k, _, v = tok.partition(":")
                if v:
                    ix.append(int(k))
                    vs.append(float(v))
            ip.append(len(ix))
    return (onp.asarray(labels, "float32"), onp.asarray(ip, "int64"),
            onp.asarray(ix, "int64"), onp.asarray(vs, "float32"))
