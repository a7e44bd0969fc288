"""A GluonNLP-style BERT pretraining step, as a user of MXNet 1.x writes it
with the framework's ops, against ``mxnet_tpu_torch``.

The model is BERT-Base by default (12 layers, 768 units, 12 heads, FFN
3072, vocabulary 30522, max_length 512, GELU, post-LN with
``layer_norm_eps`` 1e-12, the zoo's MLM and NSP heads) in GluonNLP's
time-major layout, (T, B, C). Each layer's attention is one fused
``FullyConnected(3 C)`` whose rows are interleaved per head as (H, 3, D),
then ``interleaved_matmul_selfatt_qk(heads=H)``, ``masked_softmax`` over the
valid-length mask, ``interleaved_matmul_selfatt_valatt`` and the output
projection (GluonNLP's ``BERTEncoder`` over MXNet's
``src/operator/contrib/transformer.cc``). Positions come from
``arange_like``, the MLM and NSP losses from ``softmax_cross_entropy`` (the
MLM head decodes the masked positions only, as GluonNLP's), LayerNorm from
the registry's ``layer_norm``.

The weights are the zoo's: :func:`load_params` reads a
``BERTForPretraining`` ``.params`` file of either package and permutes
``attn_qkv``'s rows and bias from the zoo's [q | k | v] to the per-head
(H, 3, D) order, ``W.reshape(3, H, D, C).transpose(0, 1).reshape(3 H D,
C)``; so the encoder can be held against the zoo's ``BERTModel`` (its
``multihead_attention`` route) on the same weights.

The training step is MXNet 1.x's, eager: bf16 Dense weights (the embedding
tables and the LayerNorm parameters fp32, as AMP keeps them) with fp32
masters; ``amp_cast`` to bf16 at the embedding output and to fp32 on the
logits into the losses; ``autograd.record()`` and ``backward()`` of the
loss times a dynamic loss scale; ``multi_all_finite`` over the gradients,
the scale halved and the step skipped on overflow; then one
``multi_mp_lamb_update`` over every parameter tensor, written back through
``out=``. :func:`train_step_phases` is the fp32 form: ``lamb_update_phase1``,
the two norms and ``lamb_update_phase2`` a tensor.

The functions take the framework module (``mxnet_tpu_torch`` by default),
so that the tests run the same body in the JAX package. A helper of the
tests and of ``chip_smoke.py``, not a test; it imports only numpy and the
package it is given (and torch for :func:`f64_grads`).
``PYTHONPATH=. python tests/torch_script_interleaved_bert.py --layers 2
--units 64 --heads 4 --vocab 97 --batch 2 --steps 3 --device cpu`` runs it
narrow on the CPU.
"""
import argparse
import time

import numpy as onp

BASE = dict(vocab_size=30522, num_layers=12, units=768, hidden_size=3072,
            num_heads=12, max_length=512)
LN_EPS = 1e-12              # the encoder's LayerNorms (BERT's)
MLM_LN_EPS = 1e-5           # the zoo's MLM head LayerNorm (its default)
MASKED = 0.15               # BERT's share of masked positions ...
MAX_PREDICTIONS = 20        # ... at most this many a sequence (phase 1)
LAMB = dict(beta1=0.9, beta2=0.999, epsilon=1e-6)
WD = 0.01                   # on weights; none on biases, LayerNorm, tables


def config(**over):
    cfg = dict(BASE)
    cfg.update(over)
    return cfg


def param_shapes(cfg):
    """The zoo's ``BERTForPretraining(bert_base)`` parameter names and
    shapes, in its order."""
    c, f, v = cfg["units"], cfg["hidden_size"], cfg["vocab_size"]
    out = {"mlm_decoder_bias": (v,),
           "bert.position_embed": (cfg["max_length"], c),
           "bert.word_embed.weight": (v, c),
           "bert.token_type_embed.weight": (2, c),
           "bert.embed_ln.gamma": (c,), "bert.embed_ln.beta": (c,)}
    for i in range(cfg["num_layers"]):
        p = f"bert.encoder.layers.{i}."
        out.update({p + "attn_qkv.weight": (3 * c, c),
                    p + "attn_qkv.bias": (3 * c,),
                    p + "attn_proj.weight": (c, c), p + "attn_proj.bias": (c,),
                    p + "attn_ln.gamma": (c,), p + "attn_ln.beta": (c,),
                    p + "ffn_1.weight": (f, c), p + "ffn_1.bias": (f,),
                    p + "ffn_2.weight": (c, f), p + "ffn_2.bias": (c,),
                    p + "ffn_ln.gamma": (c,), p + "ffn_ln.beta": (c,)})
    out.update({"bert.pooler.weight": (c, c), "bert.pooler.bias": (c,),
                "mlm_transform.weight": (c, c), "mlm_transform.bias": (c,),
                "mlm_ln.gamma": (c,), "mlm_ln.beta": (c,),
                "nsp_classifier.weight": (2, c),
                "nsp_classifier.bias": (2,)})
    return out


def init_weights(cfg, seed=0):
    """Seeded numpy weights: N(0, 0.02) for the matrices and tables, small
    N(0, 0.02) biases, gammas 1 and betas 0 (fp32)."""
    rng = onp.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("gamma"):
            out[name] = onp.ones(shape, "float32")
        elif name.endswith("beta"):
            out[name] = onp.zeros(shape, "float32")
        else:
            out[name] = rng.standard_normal(shape, dtype=onp.float32) * 0.02
    return out


def save_params(path, weights):
    """Write ``weights`` as a ``.params`` file (the zoo's format, a numpy
    archive keyed by parameter name)."""
    with open(path, "wb") as fh:
        onp.savez(fh, **weights)


def permute_qkv(a, heads):
    """``attn_qkv``'s rows (or bias) from [q | k | v] to the per-head
    (H, 3, D) order that the interleaved ops read."""
    d = a.shape[0] // (3 * heads)
    return a.reshape((3, heads, d) + a.shape[1:]).swapaxes(0, 1).reshape(
        a.shape)


def is_fp32(name):
    """Parameters kept fp32 in the bf16 step: the LayerNorms' and the
    embedding tables (AMP's norm and lookup ops)."""
    return name.endswith(("gamma", "beta")) or "embed" in name


def weight_decay(name):
    return 0.0 if name.endswith(("bias", "gamma", "beta")) else WD


def load_params(mx, path, cfg, ctx, dtype="float32"):
    """``{name: NDArray}`` from a ``BERTForPretraining`` ``.params`` file
    written by either package: ``attn_qkv`` permuted to (H, 3, D); the
    Dense weights and biases in ``dtype``, the rest fp32 (``dtype``
    float64: everything float64)."""
    with onp.load(path) as z:
        arrays = {n: z[n] for n in z.files}
    out = {}
    for name in param_shapes(cfg):
        a = arrays[name]
        if ".attn_qkv." in name:
            a = permute_qkv(a, cfg["num_heads"])
        dt = dtype if dtype == "float64" or not is_fp32(name) else "float32"
        out[name] = mx.nd.array(a, ctx=ctx, dtype="float32").astype(dt) \
            if dt == "bfloat16" else mx.nd.array(a.astype(dt), ctx=ctx,
                                                 dtype=dt)
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def make_batch(cfg, batch, seq_len, seed=1):
    """A seeded pretraining batch (numpy, batch-major): token ids, segment
    ids (the second sentence from a seeded split), valid lengths in [seq_len
    / 4, seq_len], masked positions (15 % of each sequence's valid tokens,
    at most ``MAX_PREDICTIONS``) with their labels, and NSP labels."""
    rng = onp.random.RandomState(seed)
    v = cfg["vocab_size"]
    valid = rng.randint(max(2, seq_len // 4), seq_len + 1, size=batch)
    tokens = rng.randint(0, v, size=(batch, seq_len)).astype("int32")
    types = onp.zeros((batch, seq_len), "int32")
    pos, labels = [], []
    for b in range(batch):
        split = rng.randint(1, valid[b])
        types[b, split:valid[b]] = 1
        n = max(1, min(MAX_PREDICTIONS, int(round(valid[b] * MASKED))))
        p = onp.sort(rng.choice(valid[b], n, replace=False))
        pos.append(onp.stack([p, onp.full_like(p, b)], 1))
        labels.append(tokens[b, p].copy())
        tokens[b, p] = rng.randint(0, v, size=n)    # the corrupted inputs
    pos = onp.concatenate(pos)
    return {"tokens": tokens, "types": types,
            "valid": valid.astype("int32"),
            # row of each masked position in the time-major (T * B, C) view
            "masked_rows": (pos[:, 0] * batch + pos[:, 1]).astype("int32"),
            "mlm_labels": onp.concatenate(labels).astype("float32"),
            "nsp_labels": rng.randint(0, 2, size=batch).astype("float32")}


def attention_mask(valid, heads, seq_len):
    """(B H, 1, T) key mask of the valid lengths (1 = attend), as the
    interleaved scores' (B H, T, T) rows are laid out."""
    keys = onp.arange(seq_len)[None, :] < valid[:, None]
    return onp.repeat(keys, heads, axis=0)[:, None, :].astype("float32")


def to_nd(mx, batch, cfg, ctx):
    """The batch as NDArrays on ``ctx``, time-major where GluonNLP's are."""
    nd = mx.nd
    seq_len = batch["tokens"].shape[1]
    return {"tokens": nd.array(batch["tokens"].T.copy(), ctx=ctx,
                               dtype="int32"),
            "types": nd.array(batch["types"].T.copy(), ctx=ctx,
                              dtype="int32"),
            "mask": nd.array(attention_mask(batch["valid"], cfg["num_heads"],
                                            seq_len), ctx=ctx),
            "masked_rows": nd.array(batch["masked_rows"], ctx=ctx,
                                    dtype="int32"),
            "mlm_labels": nd.array(batch["mlm_labels"], ctx=ctx),
            "nsp_labels": nd.array(batch["nsp_labels"], ctx=ctx)}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _dense(nd, x, P, name, n):
    return nd.FullyConnected(x, P[name + ".weight"], P[name + ".bias"],
                             num_hidden=n, flatten=False)


def _drop(nd, x, p):
    return nd.Dropout(x, p=p) if p > 0 else x


def encoder(mx, P, data, cfg, dtype="float32", dropout=0.0):
    """The embeddings and the encoder: (T, B, C) in ``dtype``."""
    nd = mx.nd
    c, h = cfg["units"], cfg["num_heads"]
    tokens = data["tokens"]
    x = nd.Embedding(tokens, P["bert.word_embed.weight"],
                     input_dim=cfg["vocab_size"], output_dim=c)
    x = x + nd.Embedding(data["types"], P["bert.token_type_embed.weight"],
                         input_dim=2, output_dim=c)
    pos = nd.Embedding(nd.arange_like(tokens, axis=0),
                       P["bert.position_embed"],
                       input_dim=cfg["max_length"], output_dim=c)
    x = nd.broadcast_add(x, pos.reshape((tokens.shape[0], 1, c)))
    x = nd.LayerNorm(x, P["bert.embed_ln.gamma"], P["bert.embed_ln.beta"],
                     eps=LN_EPS)
    x = _drop(nd, nd.amp_cast(x, dtype=dtype), dropout)   # AMP's boundary
    for i in range(cfg["num_layers"]):
        p = f"bert.encoder.layers.{i}."
        qkv = _dense(nd, x, P, p + "attn_qkv", 3 * c)
        att = nd.interleaved_matmul_selfatt_qk(qkv, heads=h)
        att = _drop(nd, nd.masked_softmax(att, data["mask"], axis=-1),
                    dropout)
        ctx = nd.interleaved_matmul_selfatt_valatt(qkv, att, heads=h)
        out = _drop(nd, _dense(nd, ctx, P, p + "attn_proj", c), dropout)
        x = nd.LayerNorm(x + out, P[p + "attn_ln.gamma"],
                         P[p + "attn_ln.beta"], eps=LN_EPS)
        ffn = nd.LeakyReLU(_dense(nd, x, P, p + "ffn_1",
                                  cfg["hidden_size"]), act_type="gelu")
        ffn = _drop(nd, _dense(nd, ffn, P, p + "ffn_2", c), dropout)
        x = nd.LayerNorm(x + ffn, P[p + "ffn_ln.gamma"],
                         P[p + "ffn_ln.beta"], eps=LN_EPS)
    return x


def heads(mx, P, seq, data, cfg, dtype="float32"):
    """(MLM logits at the masked positions (N, vocab), NSP logits (B, 2)):
    the zoo's heads, the MLM decoder tied to the word embedding."""
    nd = mx.nd
    t, b, c = seq.shape
    first = nd.slice_axis(seq, axis=0, begin=0, end=1).reshape((b, c))
    pooled = nd.Activation(_dense(nd, first, P, "bert.pooler", c),
                           act_type="tanh")
    nsp = _dense(nd, pooled, P, "nsp_classifier", 2)
    h = nd.take(seq.reshape((t * b, c)), data["masked_rows"], axis=0)
    h = nd.LeakyReLU(_dense(nd, h, P, "mlm_transform", c), act_type="gelu")
    h = nd.LayerNorm(h, P["mlm_ln.gamma"], P["mlm_ln.beta"], eps=MLM_LN_EPS)
    mlm = nd.FullyConnected(
        h, nd.amp_cast(P["bert.word_embed.weight"], dtype=dtype),
        P["mlm_decoder_bias"], num_hidden=cfg["vocab_size"], flatten=False)
    return mlm, nsp


def pretrain_loss(mx, P, data, cfg, dtype="float32", loss_dtype="float32",
                  dropout=0.0, seq=None):
    """The mean MLM loss over the masked positions plus the mean NSP loss,
    (1,) in ``loss_dtype``. ``seq``: a list that receives the encoder's
    output."""
    nd = mx.nd
    x = encoder(mx, P, data, cfg, dtype, dropout)
    if seq is not None:
        seq.append(x)
    mlm, nsp = heads(mx, P, x, data, cfg, dtype)
    n_mlm, n_nsp = mlm.shape[0], nsp.shape[0]
    l_mlm = nd.softmax_cross_entropy(nd.amp_cast(mlm, dtype=loss_dtype),
                                     data["mlm_labels"])
    l_nsp = nd.softmax_cross_entropy(nd.amp_cast(nsp, dtype=loss_dtype),
                                     data["nsp_labels"])
    return l_mlm / n_mlm + l_nsp / n_nsp


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------
class LossScaler:
    """MXNet 1.x's dynamic loss scale: halved (and the step skipped) on an
    overflow, doubled after ``window`` finite steps in a row."""

    def __init__(self, scale=2.0 ** 16, window=2000):
        self.scale, self.window, self._good = float(scale), window, 0

    def update(self, finite):
        if not finite:
            self.scale, self._good = self.scale / 2, 0
            return
        self._good += 1
        if self._good >= self.window:
            self.scale, self._good = self.scale * 2, 0


def lamb_state(mx, P, ctx):
    """fp32 masters, LAMB's moments and a phase-1 buffer a parameter; every
    parameter marked for gradients."""
    nd = mx.nd
    state = {}
    for name, w in P.items():
        w.attach_grad()
        dt = "float64" if str(w.dtype) == "float64" else "float32"
        state[name] = {"w32": w.astype(dt).copy(),
                       **{k: nd.zeros(w.shape, ctx=ctx, dtype=dt)
                          for k in ("mean", "var", "upd")}}
    return state


def backward(mx, P, data, cfg, scale, dtype, loss_dtype="float32",
             dropout=0.0, seq=None):
    """The loss, and the gradients of ``loss * scale`` in ``P[...].grad``
    (``seq``: as :func:`pretrain_loss`'s)."""
    with mx.autograd.record():
        loss = pretrain_loss(mx, P, data, cfg, dtype, loss_dtype, dropout,
                             seq)
        scaled = loss * scale
    scaled.backward()
    return loss


def update_mp_lamb(mx, P, state, lr, t, scale):
    """One ``multi_mp_lamb_update`` over every tensor, written back into
    the weights, moments and masters through ``out=``."""
    names = list(P)
    args, outs = [], []
    for n in names:
        s = state[n]
        args += [P[n], P[n].grad, s["mean"], s["var"], s["w32"]]
        outs += [P[n], s["mean"], s["var"], s["w32"]]
    k = len(names)
    mx.nd.multi_mp_lamb_update(
        *args, out=outs, learning_rates=(lr,) * k,
        wds=tuple(weight_decay(n) for n in names), step_count=(t,) * k,
        rescale_grad=1.0 / scale, num_tensors=k, **LAMB)


def train_step(mx, P, state, data, cfg, scaler, lr, t, dtype="bfloat16",
               dropout=0.0):
    """One step: forward and backward of the scaled loss, the overflow
    check, one ``multi_mp_lamb_update``. Returns ``(loss, applied)``."""
    loss = backward(mx, P, data, cfg, scaler.scale, dtype, dropout=dropout)
    grads = [w.grad for w in P.values()]
    finite = bool(mx.nd.multi_all_finite(*grads, num_arrays=len(grads))
                  .asnumpy())
    if finite:
        update_mp_lamb(mx, P, state, lr, t, scaler.scale)
    scaler.update(finite)
    return float(loss.asnumpy()[0]), finite


def update_phases(mx, P, state, lr, t):
    """The fp32 form of the update: a tensor at a time,
    ``lamb_update_phase1``, ``|w|`` and ``|update|``, then
    ``lamb_update_phase2`` written back into the weight."""
    nd = mx.nd
    for n, w in P.items():
        s = state[n]
        upd = s["upd"]
        nd.lamb_update_phase1(w, w.grad, s["mean"], s["var"], t=t,
                              wd=weight_decay(n), **LAMB,
                              out=[upd, s["mean"], s["var"]])
        r1 = nd.norm(w).reshape((1,))
        r2 = nd.norm(upd).reshape((1,))
        nd.lamb_update_phase2(w, upd, r1, r2, lr=lr, out=w)


def train_step_phases(mx, P, state, data, cfg, lr, t, dropout=0.0):
    """The fp32 step: forward and backward, then :func:`update_phases`.
    Returns the loss."""
    loss = backward(mx, P, data, cfg, 1.0, "float32", dropout=dropout)
    update_phases(mx, P, state, lr, t)
    return float(loss.asnumpy()[0])


def zoo_sequence(mx, path, cfg, batch, ctx):
    """The zoo ``BERTModel``'s sequence output (B, T, C), numpy, on the
    same ``.params`` file (its ``bert.`` parameters), dropout 0."""
    from_zoo = mx.gluon.model_zoo.bert.BERTModel
    kw = dict(vocab_size=cfg["vocab_size"], num_layers=cfg["num_layers"],
              units=cfg["units"], hidden_size=cfg["hidden_size"],
              num_heads=cfg["num_heads"], max_length=cfg["max_length"],
              dropout=0.0)
    if mx.__name__ == "mxnet_tpu_torch":
        kw["device"] = ctx
    net = from_zoo(**kw)
    with onp.load(path) as z:
        arrays = {n[len("bert."):]: z[n] for n in z.files
                  if n.startswith("bert.")}
    body = path + ".body"            # the encoder's own file, beside it
    save_params(body, arrays)
    net.load_parameters(body, ctx=ctx)
    nd = mx.nd
    seq, _ = net(nd.array(batch["tokens"], ctx=ctx, dtype="int32"),
                 nd.array(batch["types"], ctx=ctx, dtype="int32"),
                 nd.array(batch["valid"], ctx=ctx, dtype="int32"))
    return seq.asnumpy()


def f64_grads(mx, path, cfg, batch):
    """Every parameter's gradient of the loss in float64 on the CPU: the
    float64 twin of the fp32 step. ``mx`` is ``mxnet_tpu_torch`` (its
    NDArrays keep float64)."""
    ctx = mx.cpu()
    with ctx:
        P = load_params(mx, path, cfg, ctx, dtype="float64")
        for w in P.values():
            w.attach_grad()
        data = to_nd(mx, batch, cfg, ctx)
        data["mask"] = data["mask"].astype("float64")
        data["mlm_labels"] = data["mlm_labels"].astype("float64")
        data["nsp_labels"] = data["nsp_labels"].astype("float64")
        backward(mx, P, data, cfg, 1.0, "float64", "float64")
        return {n: w.grad.asnumpy() for n, w in P.items()}


def main(argv=None):
    import os
    import tempfile

    import mxnet_tpu_torch as mx

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--units", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="gpu")
    args = ap.parse_args(argv)
    cfg = config(num_layers=args.layers, units=args.units,
                 num_heads=args.heads, hidden_size=4 * args.units,
                 vocab_size=args.vocab)
    ctx = mx.gpu() if args.device == "gpu" else mx.cpu()
    with tempfile.TemporaryDirectory() as tmp, ctx:
        path = os.path.join(tmp, "bert.params")
        save_params(path, init_weights(cfg))
        P = load_params(mx, path, cfg, ctx, dtype="bfloat16")
        state = lamb_state(mx, P, ctx)
        data = to_nd(mx, make_batch(cfg, args.batch, args.seq_len), cfg, ctx)
        scaler = LossScaler()
        t0 = time.perf_counter()
        losses = [train_step(mx, P, state, data, cfg, scaler, args.lr, i + 1,
                             dropout=0.1)[0] for i in range(args.steps)]
    print({"losses": losses, "seconds": time.perf_counter() - t0})
    return losses


if __name__ == "__main__":
    main()
