"""MXNet's legacy-symbol AlexNet and its training loop, as a user of
MXNet 1.x writes them, against ``mxnet_tpu_torch``.

The symbol has the layers of apache/incubator-mxnet's
``example/image-classification/symbols/alexnet.py`` (after Krizhevsky et
al. 2012): ``conv1`` 11x11/4 (96), ``relu1``, ``lrn1``, ``pool1`` max
3x3/2, ``conv2`` 5x5 pad 2 (256), ``relu2``, ``lrn2``, ``pool2``,
``conv3``/``conv4`` 3x3 pad 1 (384), ``conv5`` (256), ``pool3``,
``Flatten``, ``fc1``/``fc2`` 4096 with ReLU and ``Dropout(0.5)``, and
``fc3`` over the classes; ``LRN(alpha=1e-4, beta=0.75, knorm=2,
nsize=5)``. ``train_imagenet.py`` trained it at ``--image-shape 3,224,224``,
batch 128, 1000 classes. The weights and biases are variables named as the
published script's layers name them (``conv1_weight``, ...).

Two changes from the published script, each marked where it is:

- the loss head. ``SoftmaxOutput`` maps to a plain ``softmax`` with no loss
  gradient in this framework (``symbol._LEGACY_NAMES``), so training ends in
  ``MakeLoss(_mul_scalar(pick(log_softmax(fc3), label), scalar=-1),
  grad_scale=1/B)`` and prediction in ``SoftmaxActivation(fc3)``;
- ``Dropout`` follows its ``training`` attribute, not the executor's
  ``is_train``, so the prediction symbol is built with ``training=False``.

The loop is ``simple_bind(ctx, grad_req="write", **shapes)``, then
``forward(is_train=True, data=..., label=...)`` and ``backward()``, then
``get_updater(SGD(learning_rate=0.01, momentum=0.9, wd=5e-4))`` over the
weights by index, as ``Module.update`` did. The weights come from a numpy
seed. ``width`` divides every channel and hidden width, and ``image`` sets
the input's side, so a test can run the same graph narrow.

The functions take the framework module (``mxnet_tpu_torch`` by default),
so that the tests can build the same symbol in the JAX package. A helper
of the tests and of ``chip_smoke.py``, not a test; it imports only numpy
and the package it is given (and torch for :func:`f64_grads`).
``PYTHONPATH=. python tests/torch_script_legacy_alexnet.py --width 16
--image 67 --batch 2 --steps 3 --device cpu`` runs it narrow on the CPU.
"""
import argparse
import time

import numpy as onp

LRN = dict(alpha=1e-4, beta=0.75, knorm=2, nsize=5)


def _widths(width, num_classes):
    w = max(1, int(width))
    return dict(c1=96 // w, c2=256 // w, c3=384 // w, c5=256 // w,
                fc=4096 // w, classes=num_classes)


def _conv_out(n, k, s=1, p=0):
    return (n + 2 * p - k) // s + 1


def arg_shapes(width=1, image=224, num_classes=1000, batch=128):
    """The shape of every argument of :func:`alexnet_symbol`'s graph, in
    the graph's order (data and label first)."""
    c = _widths(width, num_classes)
    s = _conv_out(image, 11, 4)             # conv1
    s = _conv_out(s, 3, 2)                  # pool1
    s = _conv_out(s, 3, 2)                  # pool2 (conv2 keeps the side)
    s = _conv_out(s, 3, 2)                  # pool3 (conv3-5 keep it)
    flat = c["c5"] * s * s
    return {"data": (batch, 3, image, image), "label": (batch,),
            "conv1_weight": (c["c1"], 3, 11, 11), "conv1_bias": (c["c1"],),
            "conv2_weight": (c["c2"], c["c1"], 5, 5),
            "conv2_bias": (c["c2"],),
            "conv3_weight": (c["c3"], c["c2"], 3, 3),
            "conv3_bias": (c["c3"],),
            "conv4_weight": (c["c3"], c["c3"], 3, 3),
            "conv4_bias": (c["c3"],),
            "conv5_weight": (c["c5"], c["c3"], 3, 3),
            "conv5_bias": (c["c5"],),
            "fc1_weight": (c["fc"], flat), "fc1_bias": (c["fc"],),
            "fc2_weight": (c["fc"], c["fc"]), "fc2_bias": (c["fc"],),
            "fc3_weight": (num_classes, c["fc"]),
            "fc3_bias": (num_classes,)}


def alexnet_symbol(mx, width=1, num_classes=1000, batch=128, train=True,
                   dropout=0.5):
    """The AlexNet symbol: with the training loss head (``train``), else
    the prediction head. ``batch`` sets ``MakeLoss``'s ``grad_scale``."""
    c = _widths(width, num_classes)
    sym = mx.sym
    data = sym.var("data")

    def conv(x, name, kernel, num_filter, stride=(1, 1), pad=(0, 0)):
        return sym.Convolution(x, sym.var(f"{name}_weight"),
                               sym.var(f"{name}_bias"), kernel=kernel,
                               stride=stride, pad=pad,
                               num_filter=num_filter, name=name)

    def fc(x, name, num_hidden):
        return sym.FullyConnected(x, sym.var(f"{name}_weight"),
                                  sym.var(f"{name}_bias"),
                                  num_hidden=num_hidden, name=name)

    def drop(x, name):
        # changed: Dropout follows ``training``, not the executor's is_train
        return sym.Dropout(x, p=dropout, training=train, name=name)

    # stage 1
    x = conv(data, "conv1", (11, 11), c["c1"], stride=(4, 4))
    x = sym.Activation(x, act_type="relu", name="relu1")
    x = sym.LRN(x, name="lrn1", **LRN)
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(2, 2),
                    name="pool1")
    # stage 2
    x = conv(x, "conv2", (5, 5), c["c2"], pad=(2, 2))
    x = sym.Activation(x, act_type="relu", name="relu2")
    x = sym.LRN(x, name="lrn2", **LRN)
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(2, 2),
                    name="pool2")
    # stage 3
    x = conv(x, "conv3", (3, 3), c["c3"], pad=(1, 1))
    x = sym.Activation(x, act_type="relu", name="relu3")
    x = conv(x, "conv4", (3, 3), c["c3"], pad=(1, 1))
    x = sym.Activation(x, act_type="relu", name="relu4")
    x = conv(x, "conv5", (3, 3), c["c5"], pad=(1, 1))
    x = sym.Activation(x, act_type="relu", name="relu5")
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(2, 2),
                    name="pool3")
    # stage 4
    x = sym.Flatten(x, name="flatten")
    x = drop(sym.Activation(fc(x, "fc1", c["fc"]), act_type="relu",
                            name="relu6"), "dropout1")
    # stage 5
    x = drop(sym.Activation(fc(x, "fc2", c["fc"]), act_type="relu",
                            name="relu7"), "dropout2")
    # stage 6
    fc3 = fc(x, "fc3", num_classes)
    if not train:
        # changed: the published head is SoftmaxOutput
        return sym.SoftmaxActivation(fc3, name="softmax")
    # changed: SoftmaxOutput's loss gradient, spelled out
    nll = sym._mul_scalar(sym.pick(sym.log_softmax(fc3, axis=-1),
                                   sym.var("label"), axis=-1), scalar=-1.0)
    return sym.MakeLoss(nll, grad_scale=1.0 / batch, name="loss")


def init_weights(width=1, image=224, num_classes=1000, seed=0):
    """Seeded numpy weights: Xavier-uniform weights (fan-in plus fan-out)
    and zero biases, fp32."""
    rng = onp.random.RandomState(seed)
    out = {}
    for name, shape in arg_shapes(width, image, num_classes).items():
        if name in ("data", "label"):
            continue
        if name.endswith("_bias"):
            out[name] = onp.zeros(shape, "float32")
            continue
        recept = int(onp.prod(shape[2:])) if len(shape) > 2 else 1
        bound = onp.sqrt(6.0 / ((shape[0] + shape[1]) * recept))
        out[name] = rng.uniform(-bound, bound, shape).astype("float32")
    return out


def synthetic_batches(n, batch, image=224, num_classes=1000, seed=1):
    """``n`` fixed batches of N(0, 1) images and uniform labels (float32,
    as an ``NDArrayIter`` gives them)."""
    rng = onp.random.RandomState(seed)
    return [(rng.standard_normal((batch, 3, image, image)).astype("float32"),
             rng.randint(0, num_classes, size=batch).astype("float32"))
            for _ in range(n)]


def bind(mx, sym, weights, batch, image, ctx, grad_req="write"):
    """``simple_bind`` on ``ctx`` with the weights copied in."""
    shapes = {n: s for n, s in arg_shapes(1, image, 1, batch).items()
              if n in ("data", "label")}
    shapes.update({n: w.shape for n, w in weights.items()})
    shapes = {n: shapes[n] for n in sym.list_arguments()}
    exe = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
    for name, w in weights.items():
        exe.arg_dict[name][:] = mx.nd.array(w, ctx=ctx)
    return exe


def param_names(sym):
    return [n for n in sym.list_arguments() if n not in ("data", "label")]


def train(mx, exe, sym, batches, steps, ctx, on_step=None):
    """``steps`` SGD steps over ``batches`` cycled; returns each step's
    mean loss. ``on_step(step)`` runs after each update."""
    opt = mx.optimizer.SGD(learning_rate=0.01, momentum=0.9, wd=5e-4)
    updater = mx.optimizer.get_updater(opt)
    names = param_names(sym)
    losses = []
    for step in range(steps):
        data, label = batches[step % len(batches)]
        out = exe.forward(is_train=True, data=mx.nd.array(data, ctx=ctx),
                          label=mx.nd.array(label, ctx=ctx))
        exe.backward()
        for i, name in enumerate(names):
            w = exe.arg_dict[name]
            updater(i, w.grad, w)
        losses.append(out[0])
        if on_step is not None:
            on_step(step)
    return [float(onp.asarray(loss.asnumpy()).mean()) for loss in losses]


def f64_grads(mx, sym, weights, batch):
    """Every weight's gradient of ``sym`` (one batch ``(data, label)``) in
    float64 on the CPU: the float64 twin of the fp32 graph. ``mx`` is
    ``mxnet_tpu_torch`` (its NDArrays keep float64)."""
    import torch

    data, label = batch
    args = {n: torch.from_numpy(w.astype("float64"))
            for n, w in weights.items()}
    args["data"] = torch.from_numpy(data.astype("float64"))
    args["label"] = torch.from_numpy(label.astype("float64"))
    names = sym.list_arguments()
    nd = {n: mx.nd.NDArray(args[n]) for n in names}
    grads = {n: mx.nd.NDArray(torch.zeros_like(args[n])) for n in names}
    exe = sym.bind(mx.cpu(), args=nd, args_grad=grads)
    exe.forward(is_train=True)
    exe.backward()
    return {n: grads[n].asnumpy() for n in param_names(sym)}


def main(argv=None):
    import mxnet_tpu_torch as mx

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="gpu")
    args = ap.parse_args(argv)
    ctx = mx.gpu() if args.device == "gpu" else mx.cpu()
    sym = alexnet_symbol(mx, args.width, args.classes, args.batch)
    weights = init_weights(args.width, args.image, args.classes)
    batches = synthetic_batches(4, args.batch, args.image, args.classes)
    exe = bind(mx, sym, weights, args.batch, args.image, ctx)
    t0 = time.perf_counter()
    losses = train(mx, exe, sym, batches, args.steps, ctx)
    print({"losses": losses, "seconds": time.perf_counter() - t0})
    return losses


if __name__ == "__main__":
    main()
