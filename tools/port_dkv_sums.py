#!/usr/bin/env python3
"""A/B of the dK/dV kernel's fp32 tile sums on one GPU.

``mxnet_tpu_torch/csrc/flash_bwd.cu`` sums each query tile from zero in the
tensor cores' accumulator and adds it to running sums in shared memory
(``tile_sums<float>()``), because the accumulator truncates on every mma.
This script builds the source as it is and a variant whose ``tile_sums``
is false for every dtype (the sums stay in the accumulator across all
queries), holds both to a float64 answer and to the plain version at the
GPT-2 training shape (4*12, 1024, 64) causal and at (4*12, 512, 64) with
padding ids, and times both by CUDA-graph replays in the order kernel,
variant, variant, kernel. Run from the root of a checkout::

    python3 tools/port_dkv_sums.py
"""
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_variant(_build, out_dir):
    """Compile flash_bwd.cu (its float32 and bfloat16 instances) with
    ``tile_sums`` false in flash_bwd.cuh into ``out_dir``; returns (Popen,
    library path)."""
    src = (_build.CSRC / "flash_bwd.cuh").read_text()
    on = "  return std::is_same<T, float>::value;\n}"
    if src.count(on) != 1:
        raise SystemExit("tile_sums<T>() not found in flash_bwd.cuh")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_bwd_register_sums.cuh").write_text(
        src.replace(on, "  return false;\n}"))
    cu = out_dir / "flash_bwd_register_sums.cu"
    cu.write_text((_build.CSRC / "flash_bwd.cu").read_text().replace(
        '"flash_bwd.cuh"', '"flash_bwd_register_sums.cuh"'))
    lib = out_dir / "libflash_bwd_register_sums.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
           str(_build.CSRC), "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main():
    import numpy as onp
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("port_dkv_sums: FAIL: no CUDA device visible")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    proc, lib = build_variant(_build, _build.BUILD_DIR / "ab")
    _build.build(["flash_fwd", "flash_bwd_dkv"])
    log, _ = proc.communicate()
    if proc.returncode != 0:
        print(log)
        return 1
    print(f"[build] both in {time.perf_counter() - t0:.1f} s", flush=True)
    fn = getattr(ctypes.CDLL(str(lib)), _build.SOURCES["flash_bwd_dkv"][1])
    fn.argtypes = _build.SOURCES["flash_bwd_dkv"][2]
    fn.restype = ctypes.c_int

    def variant(q, k, v, g, lse, delta, qs, ks, scale, causal):
        B, H, Tq, D = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *ck._seg_ptrs(qs, ks),
                dk.data_ptr(), dv.data_ptr(), B * H, H, Tq, k.shape[2], D,
                float(scale), int(causal), ck._DTYPE_CODE[q.dtype], 32, 32,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant launch failed: CUDA error {rc}")
        return dk, dv

    dev = torch.device("cuda")
    rng = onp.random.RandomState(0)
    B, H, D, scale = 4, 12, 64, 0.125
    for T, seg in ((1024, False), (512, True)):
        q, k, v, qs, ks = cs._flash_inputs(rng, dev, B, H, T, T, D, seg)
        g = torch.from_numpy(rng.randn(B, H, T, D).astype("float32")).to(dev)
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, True)
        delta = (g * out).sum(-1)
        args = (q, k, v, g, lse, delta, qs, ks, scale, True)
        exact = cs.dkv_float64(q, k, v, g, qs, ks, scale, True)
        _, rk, rv = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                           scale, True)
        runs = {"kernel (tile sums)": ck.flash_bwd_dkv_cuda(*args),
                "variant (register sums)": variant(*args),
                "plain": (rk, rv)}
        torch.cuda.synchronize()
        for name, (dk, dv) in runs.items():
            print(f"T={T} seg={seg} {name}: max |diff| against float64 dk "
                  f"{float((dk.double() - exact[0]).abs().max()):.3g} dv "
                  f"{float((dv.double() - exact[1]).abs().max()):.3g}; "
                  f"against plain dk {float((dk - rk).abs().max()):.3g} dv "
                  f"{float((dv - rv).abs().max()):.3g}", flush=True)
        print(f"T={T} seg={seg}: max |dk| "
              f"{float(exact[0].abs().max()):.3g}, max |dv| "
              f"{float(exact[1].abs().max()):.3g}")

        def kern():
            ck.flash_bwd_dkv_cuda(*args)

        def var():
            variant(*args)

        ms = [cs.graph_ms(f) for f in (kern, var, var, kern)]
        print(f"T={T} seg={seg}: graph ms kernel / variant / variant / "
              f"kernel {ms}", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
