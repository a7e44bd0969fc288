"""Runtime-compiled CUDA kernels (reference: python/mxnet/rtc.py over
src/common/rtc.cc, MXNet's NVRTC ``CudaModule``).

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasModule``/``PallasKernel``
compile Pallas (Python) source and launch it through ``pl.pallas_call``. On
this card the source is CUDA C again, as in MXNet: ::

    mod = rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float* x, const float* y,
                                    float* out, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) out[i] = 2.0f * x[i] + y[i];
    }''')
    k = mod.get_kernel("axpy", "const float* x, const float* y, float* out,"
                       " int n", out_shapes=[(n,)])
    out = k.launch([x, y, n])                       # one thread an element
    out = k.launch([x, y, n], (n // 256, 1, 1), (256, 1, 1))

Build: the source, plus one generated ``extern "C"`` launcher a kernel that
calls ``cudaLaunchKernel``, is compiled by nvcc for ``sm_90a`` at
construction (``ops/_build.compile_source``: the kernels' flags, cached under
``mxnet_tpu_torch/_build/`` by a digest of the text) and loaded with ctypes.
A failed compile raises :class:`MXNetError` with nvcc's log; nothing falls
back. Launchable kernels: every ``extern "C" __global__`` kernel of the
source, and every name in ``exports`` (which may name a template instance,
``"axpy<float>"``). Launches go to torch's current stream and do not
synchronise.

``signature`` is the kernel's C parameter list. Tensors in ``args`` fill its
pointer parameters in order, then outputs made from ``out_shapes`` (and
``out_dtypes``, float32 by default; not zeroed) fill the remaining pointer
parameters; Python numbers fill its scalar parameters in order.
"""
from __future__ import annotations

import ctypes
import re

import torch

from .base import MXNetError, to_dtype
from .ops import _build

__all__ = ["CudaModule", "CudaKernel", "parse_signature", "launch_count",
           "reset_launch_count"]

# launches of runtime-compiled kernels since the last reset (plain int; the
# launch below is its only writer)
rtc_launches = 0

# C base type -> (ctypes scalar type, torch dtype of a pointer to it)
_C_TYPES = {
    "float": (ctypes.c_float, torch.float32),
    "double": (ctypes.c_double, torch.float64),
    "int": (ctypes.c_int, torch.int32),
    "int32_t": (ctypes.c_int32, torch.int32),
    "unsigned": (ctypes.c_uint, None),
    "unsigned int": (ctypes.c_uint, None),
    "uint32_t": (ctypes.c_uint32, None),
    "long": (ctypes.c_long, torch.int64),
    "long long": (ctypes.c_longlong, torch.int64),
    "int64_t": (ctypes.c_int64, torch.int64),
    "size_t": (ctypes.c_size_t, None),
    "bool": (ctypes.c_bool, torch.bool),
    "char": (ctypes.c_byte, torch.int8),
    "int8_t": (ctypes.c_int8, torch.int8),
    "unsigned char": (ctypes.c_ubyte, torch.uint8),
    "uint8_t": (ctypes.c_uint8, torch.uint8),
    "half": (None, torch.float16),
    "__half": (None, torch.float16),
    "__nv_bfloat16": (None, torch.bfloat16),
    "void": (None, None),
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict"}
_EXTERN_C_KERNEL = re.compile(
    r'extern\s+"C"\s+__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?'
    r'void\s+(\w+)\s*\(')


def launch_count():
    return rtc_launches


def reset_launch_count():
    global rtc_launches
    rtc_launches = 0


def parse_signature(signature):
    """``"const float *x, float *y, float alpha"`` -> a list of
    ``(name, base type, is_pointer)``; names are optional."""
    params = []
    for i, raw in enumerate(p.strip() for p in signature.split(",")):
        if not raw:
            raise MXNetError(f"empty parameter {i} in signature "
                             f"{signature!r}")
        is_ptr = "*" in raw
        if raw.count("*") > 1:
            raise MXNetError(f"parameter {raw!r}: pointers to pointers are "
                             "not supported")
        words = [w for w in raw.replace("*", " * ").split()
                 if w not in _QUALIFIERS and w != "*"]
        name = f"arg{i}"
        if len(words) > 1 and " ".join(words) not in _C_TYPES:
            name = words.pop()
        base = " ".join(words)
        if base not in _C_TYPES or (not is_ptr and _C_TYPES[base][0] is None):
            raise MXNetError(
                f"parameter {raw!r}: unsupported C type {base!r} (scalars: "
                f"{sorted(k for k, v in _C_TYPES.items() if v[0])}; "
                "pointers may also be half, __nv_bfloat16 or void)")
        params.append((name, base, is_ptr))
    return params


class CudaKernel:
    """One launchable kernel of a :class:`CudaModule`."""

    def __init__(self, fn, name, params, out_shapes, out_dtypes):
        self._fn = fn
        self.name = name
        self._params = params
        self._out_shapes = [tuple(int(n) for n in s) for s in out_shapes]
        self._out_dtypes = [to_dtype(d) for d in out_dtypes]

    def launch(self, args, *launch_dims):
        """Launch on ``args`` (tensors, then Python numbers, each in the
        order of their parameters) with ``launch_dims`` = ``(grid_dims,
        block_dims[, shared_mem])``; without them one thread per element of
        the first output, 256 to a block. Returns the outputs: a tensor, a
        tuple of them, or None without outputs."""
        global rtc_launches
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        scalars = [a for a in args if not isinstance(a, torch.Tensor)]
        ptrs = [p for p in self._params if p[2]]
        n_scalar = len(self._params) - len(ptrs)
        if len(tensors) + len(self._out_shapes) != len(ptrs) or \
                len(scalars) != n_scalar:
            raise MXNetError(
                f"{self.name}: {len(tensors)} tensors + "
                f"{len(self._out_shapes)} outputs and {len(scalars)} "
                f"numbers do not fill {len(ptrs)} pointer and {n_scalar} "
                "scalar parameters")
        dev = tensors[0].device if tensors else torch.device(
            "cuda", torch.cuda.current_device())
        torch.cuda.init()
        outs = [torch.empty(s, dtype=d, device=dev)
                for s, d in zip(self._out_shapes, self._out_dtypes)]
        keep = []
        it_t, it_s = iter(tensors + outs), iter(scalars)
        for name, base, is_ptr in self._params:
            if is_ptr:
                t = next(it_t)
                want = _C_TYPES[base][1]
                if t.device != dev or t.device.type != "cuda" or \
                        not t.is_contiguous():
                    raise MXNetError(
                        f"{self.name}: {name} must be a contiguous tensor "
                        f"on {dev}, got {t.device}")
                if want is not None and t.dtype != want:
                    raise MXNetError(
                        f"{self.name}: {name} is {base}* but the tensor is "
                        f"{t.dtype}")
                keep.append(ctypes.c_void_p(t.data_ptr()))
            else:
                keep.append(_C_TYPES[base][0](next(it_s)))
        argv = (ctypes.c_void_p * max(len(keep), 1))(
            *[ctypes.addressof(k) for k in keep])
        grid, block, smem = self._dims(launch_dims, outs)
        rc = self._fn(argv, *grid, *block, smem,
                      torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise MXNetError(
                f"rtc kernel {self.name} launch failed: CUDA error {rc}")
        rtc_launches += 1
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _dims(self, launch_dims, outs):
        if not launch_dims:
            if not outs:
                raise MXNetError(
                    f"{self.name}: without outputs, pass (grid_dims, "
                    "block_dims) to launch")
            n = max(outs[0].numel(), 1)
            return (-(-n // 256), 1, 1), (256, 1, 1), 0
        if len(launch_dims) not in (2, 3):
            raise MXNetError(
                f"{self.name}: launch dims are (grid_dims, block_dims"
                f"[, shared_mem]), got {launch_dims!r}")

        def dim3(d):
            d = tuple(int(x) for x in (d if isinstance(d, (tuple, list))
                                       else (d,)))
            if not 1 <= len(d) <= 3 or min(d) < 1:
                raise MXNetError(f"{self.name}: bad launch dims {d}")
            return d + (1,) * (3 - len(d))

        smem = int(launch_dims[2]) if len(launch_dims) == 3 else 0
        return dim3(launch_dims[0]), dim3(launch_dims[1]), smem


class CudaModule:
    """Compile CUDA C source at run time (MXNet's ``CudaModule``)."""

    def __init__(self, source, options=(), exports=()):
        if "__global__" not in source:
            raise MXNetError(
                "rtc.CudaModule compiles CUDA C; the source defines no "
                "__global__ kernel. Python (Pallas) kernel source, as the "
                "JAX package's rtc takes, is not supported by the CUDA "
                "port: write an extern \"C\" __global__ kernel")
        if not torch.cuda.is_available():
            raise MXNetError(
                "rtc.CudaModule needs an NVIDIA GPU: no CUDA device is "
                "visible (the module is compiled with nvcc for sm_90a and "
                "launched on the card)")
        names = list(dict.fromkeys(
            _EXTERN_C_KERNEL.findall(source) + [str(e) for e in exports]))
        if not names:
            raise MXNetError(
                "rtc.CudaModule: no launchable kernel: declare kernels "
                "extern \"C\" __global__ or name them in exports")
        self._index = {n: i for i, n in enumerate(names)}
        launchers = "\n".join(
            f'extern "C" int mxtt_rtc_launch_{i}(void** args, unsigned gx, '
            f"unsigned gy, unsigned gz, unsigned bx, unsigned by, "
            f"unsigned bz, unsigned smem, void* stream) {{\n"
            f"  cudaError_t e = cudaLaunchKernel((const void*)(&{n}), "
            f"dim3(gx, gy, gz), dim3(bx, by, bz), args, smem, "
            f"(cudaStream_t)stream);\n"
            f"  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();\n"
            f"}}"
            for i, n in enumerate(names))
        text = (f"#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"
                f"#include <cuda_fp16.h>\n{source}\n\n"
                "// launchers generated by mxnet_tpu_torch.rtc\n"
                f"{launchers}\n")
        self._lib = ctypes.CDLL(str(_build.compile_source(
            text, "rtc", tuple(options))))
        self.kernel_names = names

    def get_kernel(self, name, signature=None, out_shapes=(),
                   out_dtypes=None):
        """The kernel ``name`` with its C parameter list ``signature``;
        ``out_shapes``/``out_dtypes`` describe the outputs ``launch``
        allocates and passes after the input tensors."""
        if name not in self._index:
            raise MXNetError(
                f"kernel {name!r} is not launchable from this module "
                f"(launchable: {list(self._index)}); declare it extern "
                "\"C\" __global__ or name it in exports")
        if signature is None:
            raise MXNetError(
                f"get_kernel({name!r}): the CUDA port needs the kernel's C "
                "parameter list as signature")
        dtypes = list(out_dtypes) if out_dtypes is not None else \
            ["float32"] * len(out_shapes)
        if len(dtypes) != len(out_shapes):
            raise MXNetError(f"get_kernel({name!r}): {len(out_shapes)} "
                             f"out_shapes but {len(dtypes)} out_dtypes")
        fn = getattr(self._lib, f"mxtt_rtc_launch_{self._index[name]}")
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return CudaKernel(fn, name, parse_signature(signature),
                          list(out_shapes), dtypes)
