"""PyTorch/CUDA port: ``mx.initializer``'s user surface against the JAX
package's.

What a user writes with ``mx.initializer`` in the reference works the same
in the port (``mxnet_tpu/initializer.py:18-68``): a subclass overriding the
two-argument ``_init_weight(self, name, arr)``, initializers called on an
NDArray (``Constant``, ``Mixed``, ``Load``), ``register`` with ``create`` by
name, and ``create(None)``. Every case fills the same numbers in both
packages on the CPU (deterministic fills; exact equality).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import np as tnp


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ramp(shape):
    return (onp.arange(onp.prod(shape), dtype="float32")
            .reshape(shape) / 10 - 1)


def _user_inits(jinit, tinit_):
    """The same user initializer written against each package: the
    reference's two-argument ``_init_weight`` writing through ``arr[:]``."""
    class JRamp(jinit.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = _ramp(arr.shape)

    class TRamp(tinit_.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = _ramp(arr.shape)

    return JRamp, TRamp


def test_user_subclass_with_two_argument_init_weight():
    """``net.initialize(MyInit())`` on a Dense layer: the weight gets the
    subclass's fill, the bias the reference's zeros (by name)."""
    import mxnet_tpu as mx
    from mxnet_tpu import initializer as jinit

    JRamp, TRamp = _user_inits(jinit, tinit)
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize(JRamp())
    tnet = tmx.gluon.nn.Dense(3, in_units=4, device="cpu")
    tnet.initialize(TRamp())
    for n in ("weight", "bias"):
        want = getattr(jnet, n).data().asnumpy()
        got = getattr(tnet, n).detach().numpy()
        onp.testing.assert_array_equal(got, want, err_msg=n)
    assert float(onp.abs(tnet.weight.detach().numpy()).max()) > 0
    # called directly on an NDArray too
    jarr = mx.np.zeros((2, 5))
    tarr = tnp.zeros((2, 5))
    JRamp()("w_weight", jarr)
    TRamp()("w_weight", tarr)
    onp.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())


@pytest.mark.parametrize("case", ["constant", "constant_bias",
                                  "constant_array", "mixed", "load",
                                  "load_default"])
def test_initializers_called_on_ndarrays(case):
    """``Constant``, ``Mixed`` and ``Load`` called as the reference's users
    call them, on an NDArray, fill it in place with the reference's
    numbers."""
    import mxnet_tpu as mx
    from mxnet_tpu import initializer as jinit

    shape = (3, 4)
    saved = _ramp(shape) * 3
    name = "fc_weight"
    if case == "constant":
        make = (lambda m: m.Constant(0.5))
    elif case == "constant_bias":
        name = "fc_bias"                  # the fill by name wins: zeros
        make = (lambda m: m.Constant(0.5))
    elif case == "constant_array":
        make = (lambda m: m.Constant(onp.full(shape, 2.5, "float32")))
    elif case == "mixed":
        make = (lambda m: m.Mixed(["fc_.*", ".*"],
                                  [m.Constant(0.25), m.Zero()]))
    elif case == "load":
        make = (lambda m: m.Load({"arg:fc_weight": saved}))
    else:
        name = "other_weight"             # not in the dict: the default
        make = (lambda m: m.Load({"fc_weight": saved},
                                 default_init=m.One()))
    jarr = mx.np.full(shape, -7.0)
    tarr = tnp.full(shape, -7.0)
    make(jinit)(name, jarr)
    make(tinit)(name, tarr)
    assert tarr.dtype == onp.float32
    onp.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    assert not (tarr.asnumpy() == -7.0).any()


def test_initializer_fills_an_attached_ndarray_in_place():
    """An NDArray taking gradients is filled in place, the same object,
    its gradient kept attached."""
    tarr = tnp.zeros((2, 3))
    tarr.attach_grad()
    data = tarr._data
    tinit.Constant(1.5)("p_weight", tarr)
    assert tarr._data is data
    assert (tarr.asnumpy() == 1.5).all()


def test_register_and_create_by_name():
    """``@register`` makes a user's initializer known to ``create`` by its
    lower-cased class name (and to ``initialize("name")``); ``register`` is
    in ``__all__`` in both packages."""
    import mxnet_tpu as mx
    from mxnet_tpu import initializer as jinit

    JRamp, TRamp = _user_inits(jinit, tinit)
    JRamp.__name__ = TRamp.__name__ = "SurfaceRamp"
    assert jinit.register(JRamp) is JRamp
    assert tinit.register(TRamp) is TRamp
    assert "register" in jinit.__all__ and "register" in tinit.__all__
    assert isinstance(tinit.create("surfaceramp"), TRamp)
    assert isinstance(tinit.create("SURFACERAMP"), TRamp)

    @tinit.register(name="surface_half")
    class Half(tinit.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = 0.5

    assert isinstance(tinit.create("surface_half"), Half)
    jarr, tarr = mx.np.zeros((2, 2)), tnp.zeros((2, 2))
    jinit.create("surfaceramp")("x_weight", jarr)
    tinit.create("surfaceramp")("x_weight", tarr)
    onp.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    net = tmx.gluon.nn.Dense(2, in_units=2, device="cpu")
    net.initialize("surfaceramp")
    onp.testing.assert_array_equal(net.weight.detach().numpy(),
                                   _ramp((2, 2)))
    with pytest.raises(tmx.MXNetError, match="unknown initializer"):
        tinit.create("no_such_initializer")


def test_create_none_is_the_default_uniform():
    """``create(None)`` is ``Uniform(0.07)`` in both packages; a block's own
    ``None`` (no initializer of its own) still takes the block's
    default."""
    from mxnet_tpu import initializer as jinit

    jdef, tdef = jinit.create(None), tinit.create(None)
    assert type(jdef).__name__ == type(tdef).__name__ == "Uniform"
    assert jdef.scale == tdef.scale == 0.07
    arr = tnp.zeros((64, 64))
    tdef("w_weight", arr, torch.Generator().manual_seed(0))
    vals = arr.asnumpy()
    assert 0 < onp.abs(vals).max() <= 0.07
    net = tmx.gluon.nn.Dense(4, in_units=4, device="cpu")
    net.initialize(tinit.Constant(0.125))
    assert (net.weight.detach().numpy() == 0.125).all()
    assert (net.bias.detach().numpy() == 0).all()
