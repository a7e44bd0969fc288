"""Shared helpers of the tests that hold the PyTorch/CUDA port against the
JAX package (tests/test_torch_*.py): twin GPT models with one set of
weights, and the near-tie rule for comparing greedy token streams."""
import numpy as onp
import torch

VOCAB = 50
MAX_LEN = 64
NEAR_TIE = 1e-3


def numpy_weights(shapes, seed):
    """GPT weights from ``RandomState(seed)`` for ``{name: shape}``: small
    embeddings and O(1) block weights, so the tied LM head follows the
    blocks and greedy continuations vary (the JAX initializers make the
    tiny model repeat its last token)."""
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias")):
            a = 0.1 * rs.randn(*shape)
        elif "embed" in name:
            a = 0.2 * rs.randn(*shape)
        else:
            a = 2.0 * rs.randn(*shape) / onp.sqrt(shape[1])
        out[name] = a.astype("float32")
    return out


def twin_gpt(seed=11, **overrides):
    """(JAX gpt_tiny, port gpt_tiny on the CPU) holding one set of weights:
    drawn with numpy, set into the JAX model, and carried into the port by
    ``params_from_mxnet_tpu``."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as mnp
    from mxnet_tpu.gluon.model_zoo import gpt_tiny as jax_gpt_tiny

    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny

    cfg = dict(vocab_size=VOCAB, dropout=0.0, num_layers=2, units=64,
               num_heads=4, max_length=MAX_LEN)
    cfg.update(overrides)
    mx.random.seed(seed)
    jnet = jax_gpt_tiny(**cfg)
    jnet.initialize()
    jparams = jnet.collect_params()
    weights = numpy_weights({n: p.shape for n, p in jparams.items()}, seed)
    for n, p in jparams.items():
        p.set_data(mnp.array(weights[n]))
    arrays = {n: p.data().asnumpy() for n, p in jparams.items()}
    tnet = gpt_tiny(device="cpu", **cfg)
    tensors = params_from_mxnet_tpu(arrays, tnet)
    with torch.no_grad():
        for n, p in tnet.collect_params().items():
            p.copy_(tensors[n])
    return jnet, tnet


def prompts(n, lo=1, hi=16, seed=0):
    rs = onp.random.RandomState(seed)
    return [[int(t) for t in rs.randint(1, VOCAB, size=rs.randint(lo, hi))]
            for _ in range(n)]


def top2_margins(tnet, prompt, tokens):
    """Top-1 minus top-2 logit at each greedy step of ``tokens`` after
    ``prompt``, from the port's full forward."""
    seq = list(prompt) + list(tokens)
    with torch.no_grad():
        logits = tnet(torch.tensor([seq], dtype=torch.int32))[0]
    steps = logits[len(prompt) - 1:len(seq) - 1]
    top = torch.topk(steps, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def assert_greedy_agree(tnet, prompt, got, want):
    """``got`` equals ``want`` up to the first step whose top-2 margin is
    below NEAR_TIE (a near tie may fall either way across packages)."""
    margins = top2_margins(tnet, prompt, want)
    n = len(want)
    for i, m in enumerate(margins):
        if m < NEAR_TIE:
            n = i
            break
    assert got[:n] == want[:n], (n, got, want)
    assert len(got) == len(want)
