"""``examples/sparse_linear.py`` as a user would write it against the port.

The JAX package's example (a sparse linear model on LibSVM data:
``LibSVMIter(sparse=True)`` feeding ``sparse.dot`` on the device, the
legacy ``nd`` loss, ``autograd``, a hand-written SGD step), copied line for
line. Each line that differs is marked ``# port:``: the imports, the
example's pin of JAX to the CPU before its imports (gone), and ``main``'s
arguments (the file, the feature count, the batch size, the epochs and the
rate, the example's own values by default, so a caller can run the loop at
another size) and the losses it returns beside the accuracy.

A helper of the tests and of ``chip_smoke.py``, not a test; it imports only
``mxnet_tpu_torch``. The arrays land on the current context: the GPU, or
the CPU inside ``with mx.cpu():``.

Run:  python tests/torch_script_sparse.py [path.libsvm]
(with no path, a synthetic sparse binary-classification set is generated)
"""
import os
import sys
import tempfile

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxnet_tpu_torch as mx  # noqa: E402,F401  # port: was mxnet_tpu
from mxnet_tpu_torch import autograd, io, nd  # noqa: E402  # port: was mxnet_tpu
from mxnet_tpu_torch.ndarray.ndarray import NDArray  # noqa: E402  # port: was mxnet_tpu
from mxnet_tpu_torch.ndarray import sparse  # noqa: E402  # port: was mxnet_tpu


def make_synthetic(path, n=512, d=100, density=0.05, seed=7):
    rng = onp.random.RandomState(seed)
    w_true = rng.randn(d)
    with open(path, "w") as f:
        for _ in range(n):
            nnz = max(1, int(d * density))
            cols = sorted(rng.choice(d, nnz, replace=False))
            vals = rng.randn(nnz)
            y = 1 if sum(w_true[c] * v for c, v in zip(cols, vals)) > 0 \
                else 0
            f.write(str(y) + " " +
                    " ".join(f"{c}:{v:.4f}" for c, v in zip(cols, vals)) +
                    "\n")
    return d


def main(path=None, d=None, batch_size=64, epochs=25, lr=1.0):  # port: arguments
    if path is None and len(sys.argv) > 1:  # port: the path as an argument
        path, d = sys.argv[1], None
    elif path is None:  # port: the path as an argument
        path = os.path.join(tempfile.gettempdir(), "sparse_linear.libsvm")
        d = make_synthetic(path)

    it = io.LibSVMIter(path, data_shape=(d,), batch_size=batch_size,  # port: batch_size
                       sparse=True, last_batch_handle="discard")
    w = NDArray(onp.zeros((d,), "float32"))
    b = NDArray(onp.zeros((), "float32"))
    w.attach_grad()
    b.attach_grad()
    losses = []  # port: the losses, returned

    for epoch in range(epochs):  # port: epochs
        it.reset()
        total, count = 0.0, 0
        for batch in it:
            x, y = batch.data[0], batch.label[0]  # x: device CSRNDArray
            with autograd.record():
                logit = sparse.dot(x, w) + b
                # logistic loss, numerically stable
                loss = nd.mean(nd.relu(logit) - logit * y +
                               nd.log1p(nd.exp(-nd.abs(logit))))
            loss.backward()
            w._set_data(w._data - lr * w.grad._data)
            b._set_data(b._data - lr * b.grad._data)
            w.grad._set_data(w.grad._data * 0)
            b.grad._set_data(b.grad._data * 0)
            total += float(loss.asnumpy())
            losses.append(float(loss.asnumpy()))  # port: the losses
            count += 1
        print(f"epoch {epoch}: loss {total / max(count, 1):.4f}")

    # train accuracy
    it.reset()
    hit = tot = 0
    for batch in it:
        x, y = batch.data[0], batch.label[0].asnumpy()
        p = (sparse.dot(x, w) + b).asnumpy() > 0
        hit += int((p == (y > 0.5)).sum())
        tot += len(y)
    print(f"train accuracy: {hit / tot:.3f}")
    return hit / tot, losses  # port: the losses beside the accuracy


if __name__ == "__main__":
    acc, _ = main()  # port: main returns the losses too
    assert acc > 0.9, f"sparse linear model failed to fit: acc={acc}"
