#!/usr/bin/env python
"""``examples/word_lm.py`` as a user would write it against the port.

The JAX package's example, copied line for line; the lines that differ are
marked ``# port:``: the imports, ``main``'s arguments and its return of
each epoch's loss and perplexity (for the callers), and ``--export-onnx``,
which raises ``MXNetError`` naming ROADMAP A10 (4) (``contrib.onnx`` is not
ported). The example's pin of JAX to the CPU before its imports is gone.
It runs on the current context: ``with mx.cpu():`` for the host, the card
by default. A helper of the tests and of ``chip_smoke.py``, not a test; it
imports only ``mxnet_tpu_torch``.

LSTM word language model (north-star config 3; reference:
example/rnn/word_lm). Uses a local text file if given, else a synthetic
character stream, so it runs in zero-egress environments.

Run:  python tests/torch_script_word_lm.py  # port: was examples/word_lm.py
"""
from __future__ import annotations

import argparse
import os  # port: the package beside this script
import sys  # port
import time

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # port

import mxnet_tpu_torch as mx  # noqa: E402  # port: was mxnet_tpu
from mxnet_tpu_torch import autograd, gluon, np  # noqa: E402  # port
from mxnet_tpu_torch.base import MXNetError  # noqa: E402  # port
from mxnet_tpu_torch.gluon.model_zoo.rnn_lm import RNNModel  # noqa: E402  # port


def load_corpus(path=None, length=100000, vocab=64):
    if path:
        with open(path, "rb") as f:
            raw = f.read()
        chars = sorted(set(raw))
        table = {c: i for i, c in enumerate(chars)}
        data = onp.array([table[c] for c in raw], dtype="int32")
        return data, len(chars)
    rng = onp.random.RandomState(0)
    # synthetic markov-ish stream: next token depends on previous
    data = onp.zeros(length, dtype="int32")
    for i in range(1, length):
        data[i] = (data[i - 1] * 31 + rng.randint(0, 7)) % vocab
    return data, vocab


def batchify(data, batch_size):
    nb = len(data) // batch_size
    return data[:nb * batch_size].reshape(batch_size, nb)


def main(argv=None):  # port: argv, for the callers
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="optional corpus file")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bptt", type=int, default=35)
    ap.add_argument("--hidden", type=int, default=200)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--export-onnx", default=None, metavar="PATH",
                    help="after training, export the LM to this .onnx file "
                         "(fused LSTM -> ONNX LSTM nodes) and verify the "
                         "re-import numerically")
    args = ap.parse_args(argv)  # port: argv

    corpus, vocab = load_corpus(args.data)
    stream = batchify(corpus, args.batch_size)

    model = RNNModel(vocab_size=vocab, embed_size=args.hidden,
                     hidden_size=args.hidden, num_layers=args.layers,
                     dropout=0.2, tie_weights=True)
    model.initialize(mx.initializer.Xavier())
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": args.lr, "clip_gradient": 0.25})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    epochs = []  # port: each epoch's loss and perplexity, returned
    for epoch in range(args.epochs):
        tic = time.time()
        states = model.begin_state(args.batch_size)
        total, count = 0.0, 0
        for i in range(0, stream.shape[1] - 1 - args.bptt, args.bptt):
            data = np.array(stream[:, i:i + args.bptt])
            target = np.array(stream[:, i + 1:i + 1 + args.bptt])
            states = [s.detach() for s in states]
            with autograd.record():
                logits, states = model(data, states)
                loss = loss_fn(logits, target).mean()
            loss.backward()
            trainer.step(1)
            total += float(loss)
            count += 1
        ppl = onp.exp(total / count)
        print(f"Epoch {epoch}: loss {total / count:.3f} ppl {ppl:.2f} "
              f"({time.time() - tic:.1f}s)")
        epochs.append((total / count, float(ppl)))  # port: returned

    if args.export_onnx:
        # port: the reference exports the LM through contrib.onnx here and
        # checks the re-import; contrib.onnx is not ported
        raise MXNetError("--export-onnx: contrib.onnx is not ported "  # port
                         "(ROADMAP A10 (4))")  # port
    return epochs  # port: the callers read them


if __name__ == "__main__":
    main()
