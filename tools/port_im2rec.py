#!/usr/bin/env python
"""Pack an image folder into RecordIO files with the PyTorch port.

The port's copy of ``tools/im2rec.py`` (reference: tools/im2rec.py), with
the same command line and the same output: one class per top-level folder
of ``root``, numbered in sorted order; ``<prefix>.lst`` lists
``index\\tlabel\\tpath`` lines, and ``<prefix>.rec``/``<prefix>.idx`` hold the
images encoded by ``mxnet_tpu_torch.recordio.pack_img``. Usage::

    python tools/port_im2rec.py <prefix> <root> [--list] [--recursive]
        [--quality Q]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as onp  # noqa: E402


def make_list(prefix, root, recursive=False, exts=(".jpg", ".jpeg", ".png",
                                                   ".npy")):
    """Write ``<prefix>.lst``: one class per top-level folder; with
    ``recursive`` the nested folders of a class count too."""
    items = []
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    for label, cls in enumerate(classes):
        folder = os.path.join(root, cls)
        if recursive:
            files = []
            for dirpath, _, fnames in os.walk(folder):
                for fname in fnames:
                    files.append(os.path.relpath(
                        os.path.join(dirpath, fname), root))
            files.sort()
        else:
            files = [os.path.join(cls, f)
                     for f in sorted(os.listdir(folder))]
        for rel in files:
            if rel.lower().endswith(exts):
                items.append((len(items), label, rel))
    with open(prefix + ".lst", "w") as f:
        for idx, label, path in items:
            f.write(f"{idx}\t{label}\t{path}\n")
    return items


def make_rec(prefix, root, quality=95):
    """Write ``<prefix>.rec`` and ``<prefix>.idx`` from ``<prefix>.lst``."""
    from PIL import Image

    from mxnet_tpu_torch import recordio

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    with open(prefix + ".lst") as f:
        for line in f:
            idx, label, path = line.strip().split("\t")
            full = os.path.join(root, path)
            if full.endswith(".npy"):
                img = onp.load(full)
            else:
                img = onp.asarray(Image.open(full).convert("RGB"))
            header = recordio.IRHeader(0, float(label), int(idx))
            rec.write_idx(int(idx), recordio.pack_img(header, img,
                                                      quality=quality))
    rec.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true",
                    help="only generate the .lst file")
    ap.add_argument("--recursive", action="store_true",
                    help="walk nested directories under each class folder")
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args()
    make_list(args.prefix, args.root, recursive=args.recursive)
    if not args.list:
        make_rec(args.prefix, args.root, args.quality)


if __name__ == "__main__":
    main()
