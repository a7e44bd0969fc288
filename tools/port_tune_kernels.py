#!/usr/bin/env python
"""Offline CUDA-kernel autotuner of the PyTorch/CUDA port — pre-populate
the tuning cache.

Counterpart of ``tools/tune_kernels.py``, with the same flags; its defaults
are GPT-2 small's (12 heads, head dim 64, units 768). Run it once per
environment (and per model shape class) on the card, so serving processes
start with every (kernel, bucket) winner on disk and never measure
candidates online:

    # tune the ladder a GPT-2 small decode service runs
    python tools/port_tune_kernels.py --batch-ladder 1,2,4 \
        --len-ladder 8,16,32,64,128,256,512 \
        --families flash_fwd,layer_norm

    # then serve with the tuned tier on
    MXTPU_TUNE=1 python serve_my_model.py   # DecodeEngine.warmup preloads

Timing is device time (CUDA-graph replays between CUDA events). ``--cpu``
times the plain versions on the host instead: a mechanism check, whose
winners mean nothing for the card. The cache lands at
``mxnet_tpu_torch.context.tuning_cache_path()`` (override:
``MXTPU_TUNE_CACHE`` or ``--cache``), keyed by the environment signature
(interpreter, torch and CUDA versions, card name, kernel sources) — a
cache tuned under one environment is never replayed into another.

Exit code 0 on success; prints one JSON line per tuned spec and a summary
line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _ints(s):
    return tuple(int(x) for x in s.split(",") if x.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-ladder", type=_ints, default=(1, 2, 4, 8))
    ap.add_argument("--len-ladder", type=_ints, default=(128, 256, 512))
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--units", type=int, default=768,
                    help="d_model for the row-wise kernels (LayerNorm "
                         "rows are batch*len wide, units deep)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--families", default="flash_fwd,layer_norm",
                    help="comma list from: flash_fwd, flash_bwd, "
                         "layer_norm, softmax")
    ap.add_argument("--no-seg", action="store_true",
                    help="tune the plain attention variant instead of "
                         "the segment-ids one the serving prefill uses")
    ap.add_argument("--trials", type=int, default=None,
                    help="measurement rounds per candidate "
                         "(default MXTPU_TUNE_TRIALS or 3)")
    ap.add_argument("--max-per-axis", type=int, default=3,
                    help="power-of-two tile candidates per axis")
    ap.add_argument("--cpu", action="store_true",
                    help="time the plain versions on the host (mechanism "
                         "check)")
    ap.add_argument("--cache", default=None,
                    help="override the cache path (MXTPU_TUNE_CACHE)")
    args = ap.parse_args(argv)

    if args.cache:
        os.environ["MXTPU_TUNE_CACHE"] = args.cache

    from mxnet_tpu_torch import tune

    families = tuple(f.strip() for f in args.families.split(",")
                     if f.strip())
    bad = [f for f in families if f not in
           ("flash_fwd", "flash_bwd", "layer_norm", "softmax")]
    if bad:
        ap.error(f"unknown kernel families: {bad}")
    specs = tune.ladder_specs(args.batch_ladder, args.len_ladder,
                              args.num_heads, args.head_dim, args.units,
                              dtype=args.dtype, seg=not args.no_seg,
                              families=families)
    device = "cpu" if args.cpu else None
    results = []
    for spec in specs:
        r = tune.tune_one(spec, trials=args.trials,
                          max_per_axis=args.max_per_axis, device=device)
        results.append(r)
        print(json.dumps({k: r[k] for k in (
            "key", "winner", "config", "best_us", "default_us", "xla_us",
            "speedup_vs_default", "device")}), flush=True)
    path = tune.save()
    wins = sum(1 for r in results if r["winner"] != "default")
    print(json.dumps({
        "tuned_specs": len(results),
        "non_default_winners": wins,
        "measurements": tune.status()["measurements"],
        "cache_path": path,
        "next": "serve with MXTPU_TUNE=1; warmup preloads these winners",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
