"""PyTorch/CUDA port: ``rtc.CudaModule``, runtime-compiled CUDA C.

The JAX package's ``rtc`` compiles Pallas (Python) source and rejects CUDA
C; the port compiles CUDA C (nvcc, sm_90a) and rejects Python source. On
the CPU: signature parsing, the rejection of Python source, and the error
without a GPU. Marked ``cuda``: the axpy of the JAX package's test
(tests/test_contrib.py::test_pallas_module) written as CUDA C, against
``2 * x + y`` in torch.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import MXNetError, rtc

AXPY = r'''
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i] + y[i];
}
'''
AXPY_SIG = "const float* x, const float* y, float* out, int n"


def test_signature_parsing():
    assert rtc.parse_signature(AXPY_SIG) == [
        ("x", "float", True), ("y", "float", True), ("out", "float", True),
        ("n", "int", False)]
    assert rtc.parse_signature(
        "const __nv_bfloat16* __restrict__ a, unsigned int m, long long, "
        "double *") == [("a", "__nv_bfloat16", True),
                        ("m", "unsigned int", False),
                        ("arg2", "long long", False),
                        ("arg3", "double", True)]
    for bad in ("float** x", "quaternion q", "float x,", "half h"):
        with pytest.raises(MXNetError):
            rtc.parse_signature(bad)


def test_python_source_is_rejected_with_a_pointer_to_cuda_c():
    # the JAX package's own test source: a Pallas kernel in Python
    src = """
def axpy(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]
"""
    with pytest.raises(MXNetError, match="CUDA C"):
        rtc.CudaModule(src)


def test_no_gpu_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="needs an NVIDIA GPU"):
        rtc.CudaModule(AXPY)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (rtc compiles for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1000, 1 << 20])
def test_axpy_on_card(cuda, n):
    rng = onp.random.RandomState(n)
    x, y = (torch.from_numpy(rng.randn(n).astype("float32")).to(cuda)
            for _ in range(2))
    mod = rtc.CudaModule(AXPY)
    kern = mod.get_kernel("axpy", AXPY_SIG, out_shapes=[(n,)])
    c0 = rtc.launch_count()
    out = kern.launch([x, y, n])                      # default launch dims
    out2 = kern.launch([x, y, n], (-(-n // 128), 1, 1), (128, 1, 1))
    torch.cuda.synchronize()
    assert rtc.launch_count() == c0 + 2
    want = 2 * x + y
    for o in (out, out2):
        assert o.shape == (n,) and o.dtype == torch.float32
        assert float(((o - want).abs() / want.abs().clamp_min(1e-30))
                     .max()) <= 1e-6


@pytest.mark.cuda
def test_exports_template_instance_and_errors_on_card(cuda):
    src = r'''
template <typename T>
__global__ void scale(T* x, T a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * a;
}
'''
    mod = rtc.CudaModule(src, exports=["scale<float>"])
    k = mod.get_kernel("scale<float>", "float* x, float a, int n")
    x = torch.arange(10, dtype=torch.float32, device=cuda)
    assert k.launch([x, 3.0, 10], (1,), (32,)) is None
    torch.cuda.synchronize()
    assert torch.equal(x, torch.arange(10, device=cuda) * 3.0)
    with pytest.raises(MXNetError, match="launchable"):
        mod.get_kernel("scale", "float* x, float a, int n")
    with pytest.raises(MXNetError, match="int32"):
        k.launch([x.int(), 3.0, 10], (1,), (32,))
    with pytest.raises(MXNetError, match="failed"):
        rtc.CudaModule('extern "C" __global__ void broken( {')
