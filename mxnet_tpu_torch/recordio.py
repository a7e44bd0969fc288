"""RecordIO: binary record files and image-record headers (``mx.recordio``).

Counterpart of ``mxnet_tpu/recordio.py`` (reference: python/mxnet/
recordio.py, ``MXRecordIO``:36, ``MXIndexedRecordIO``:215, ``IRHeader``:343,
``pack``/``unpack``/``pack_img``). The file format is the reference's
(dmlc-core's): each record is ``u32 magic 0xced7230a | u32 length |
payload | zero padding to 4 bytes``, and an ``.idx`` sidecar holds
``key\\toffset`` lines, the offset being the byte where the record's magic
word starts. Either package reads the other's files byte for byte.

Storage goes through the framework-neutral native engine
(``src/io_native/recordio.cc``, :mod:`.io._native`), built with the host's
C++ compiler at first use. The reference falls back to a pure-Python reader
where no binary builds; the port does not: a failed build raises
:class:`MXNetError` with the compiler's output.

``pack_img``/``unpack_img`` encode and decode through PIL, as the
reference's; images are numpy arrays on the host.
"""
from __future__ import annotations

import ctypes
import io as _pyio
import os
import struct

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)
    (reference: recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self._native = None
        self._handle = None
        self._read_idx = 0
        self.open()

    def open(self):
        from .io._native import get_lib

        if self.flag not in ("r", "w"):
            raise MXNetError(f"invalid flag {self.flag}")
        self._native = get_lib()
        if self.flag == "w":
            self._handle = self._native.rio_writer_open(self.uri.encode(), 0)
        else:
            self._handle = self._native.rio_reader_open(self.uri.encode())
        if not self._handle:
            what = "writing" if self.flag == "w" else "reading"
            raise MXNetError(f"cannot open {self.uri} for {what}")
        self._read_idx = 0

    def close(self):
        if self._handle:
            if self.flag == "w":
                self._native.rio_writer_close(self._handle)
            else:
                self._native.rio_reader_free(self._handle)
            self._handle = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def num_records(self):
        """Records in a file opened for reading (its index, built when it
        was opened)."""
        return int(self._native.rio_reader_count(self._handle))

    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("recordio not opened for writing")
        rc = self._native.rio_writer_write(self._handle, buf, len(buf))
        if rc != 0:
            raise MXNetError(f"record write failed (code {rc})")

    def read(self):
        """The next record's bytes, or None after the last."""
        if self.flag != "r":
            raise MXNetError("recordio not opened for reading")
        if self._read_idx >= self.num_records:
            return None
        out = self._read_at(self._read_idx)
        self._read_idx += 1
        return out

    def _read_at(self, idx):
        size = self._native.rio_reader_size(self._handle, idx)
        buf = ctypes.create_string_buffer(size)
        if self._native.rio_reader_get(self._handle, idx, buf) != 0:
            raise MXNetError(f"record read failed at {idx}")
        return buf.raw


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records with an ``.idx`` sidecar of byte offsets
    (reference: recordio.py:215); the sidecar is written on ``close``."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self._wpos = 0
        super().__init__(uri, flag)
        if flag == "r":
            self._off2ord = {
                int(self._native.rio_reader_offset(self._handle, i)): i
                for i in range(self.num_records)}
            if os.path.exists(idx_path):
                with open(idx_path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) >= 2:
                            key = key_type(parts[0])
                            self.idx[key] = int(parts[1])
                            self.keys.append(key)

    def close(self):
        if self.flag == "w" and self._handle and self.idx:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def read_idx(self, key):
        offset = self.idx[key]
        ordinal = self._off2ord.get(offset)
        if ordinal is None:
            raise MXNetError(
                f"idx offset {offset} does not start a record in "
                f"{self.uri} (corrupt or mismatched .idx)")
        return self._read_at(ordinal)

    def write_idx(self, key, buf):
        self.idx[key] = self._wpos
        self.keys.append(key)
        self.write(buf)
        self._wpos += 8 + len(buf) + ((4 - (len(buf) & 3)) & 3)


class IRHeader:
    """Image-record header (reference: recordio.py:343): ``flag`` is the
    number of extra float labels stored after the header."""

    __slots__ = ("flag", "label", "id", "id2")
    _FMT = "<IfQQ"

    def __init__(self, flag, label, id, id2=0):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2


_HEADER_BYTES = struct.calcsize(IRHeader._FMT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A header and a payload as one record's bytes; a list or array label
    goes after the header as float32 values."""
    label = header.label
    if isinstance(label, (list, tuple, onp.ndarray)):
        label = onp.asarray(label, dtype=onp.float32)
        return struct.pack(IRHeader._FMT, len(label), 0.0, header.id,
                           header.id2) + label.tobytes() + s
    return struct.pack(IRHeader._FMT, header.flag, float(label), header.id,
                       header.id2) + s


def unpack(s: bytes):
    """(header, payload) of a record's bytes."""
    flag, label, id_, id2 = struct.unpack(IRHeader._FMT, s[:_HEADER_BYTES])
    payload = s[_HEADER_BYTES:]
    if flag > 0:
        labels = onp.frombuffer(payload[:flag * 4], dtype=onp.float32)
        return IRHeader(flag, labels, id_, id2), payload[flag * 4:]
    return IRHeader(flag, label, id_, id2), payload


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """An (H, W, C) uint8 image encoded by PIL (JPEG, or PNG for any other
    ``img_fmt``) into a record."""
    from PIL import Image

    buf = _pyio.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(onp.asarray(img)).save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=1):
    """(header, image) of an image record: the image decoded by PIL, as
    RGB where ``iscolor``."""
    from PIL import Image

    header, payload = unpack(s)
    img = Image.open(_pyio.BytesIO(payload))
    if iscolor:
        img = img.convert("RGB")
    return header, onp.asarray(img)
