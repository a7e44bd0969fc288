"""PyTorch/CUDA port: ``parallel.Learner`` against the JAX package's, on the
CPU.

The reference's ``Learner`` compiles forward, backward and an optax update
into one program; it runs here on a one-device mesh
(``make_mesh({"dp": 1}, devices=jax.devices()[:1])``: the conftest gives
JAX eight virtual devices, and the port's Learner is the one-device case).
Both packages start from the same numpy-seeded weights, carried by a
``.params`` file, and take the same numpy inputs. Checked, each with its
tolerance:

- a Dense MLP through SGD with momentum and weight decay, Adam with weight
  decay, AdamW, and SGD with ``clip_gradient``: 3 steps each, losses and
  weights within 1e-5 of each tensor's largest entry (fp32 sums in another
  order);
- a small ``BERTForPretraining`` (2 layers, 64 units, 4 heads, vocab 97)
  under ``bench.py``'s ``_PaddedBERT`` (T = 16 with 14 valid, B = 4,
  dropout 0) after ``amp.convert_hybrid_block``/``amp.init("bfloat16")``,
  AdamW with bf16 moments on both sides: 3 steps, each loss within 2e-2 of
  the reference's, each first moment in the reference's dtype and within
  0.15 of its largest entry, and each weight's update within 0.35 of the
  reference's in the Frobenius norm, leaving out the entries whose
  gradient is rounding noise (bf16 keeps 8 bits; the reference's XLA may
  keep excess precision inside its fusions, the port rounds every op; the
  bounds are set out in ``_bf16_faults``). The same bounds reject a step
  that applies no update and an AdamW with float32 moments;
- ``remat=True`` bitwise equal to the plain step with dropout 0.1 and one
  seed (the recompute draws the forward's masks again);
- the checkpoint round trip, and a mesh or ``param_spec_fn`` raising
  naming ROADMAP A8;
- the reference's own ``tests/test_parallel.py:46-150`` cases that fit one
  device: a learning step, one step against the eager ``Trainer``, remat
  against plain.

The JAX package is imported inside the tests, so ``pytest --noconftest
tests/test_torch_learner.py -m cuda`` collects this file without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, amp as tamp, autograd as tag
from mxnet_tpu_torch import gluon as tgluon, parallel as tparallel
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.parallel import learner as learner_mod

RTOL = 1e-5
BF16_TOL = 2e-2     # a bf16 loss
MOMENT_TOL = 0.15   # a bf16 first moment, of its tensor's largest entry
UPDATE_TOL = 0.35   # a bf16 weight's update, in the Frobenius norm
NOISE_FLOOR = 1e-2  # a first moment below this share of its tensor's
#                     largest is gradient noise (see _bf16_faults)
LR = 1e-3           # the BERT runs' AdamW rate
VOCAB, T, T_VALID, B = 97, 16, 14, 4
BERT_CFG = dict(vocab_size=VOCAB, num_layers=2, units=64, hidden_size=128,
                num_heads=4, max_length=T)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _np(t):
    if hasattr(t, "asnumpy"):
        return onp.asarray(t.asnumpy(), dtype="float32")
    return t.detach().float().cpu().numpy()


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
            pkg.gluon.nn.Dense(3, in_units=8))
    return net


def _one_device_mesh():
    import jax
    from mxnet_tpu import parallel

    return parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _mlp_weights(net, seed):
    rs = onp.random.RandomState(seed)
    return {n: (rs.randn(*p.shape) / onp.sqrt(p.shape[-1])).astype("float32")
            for n, p in net.collect_params().items()}


_OPTIMIZERS = {
    "sgd_momentum_wd": ("SGD", dict(learning_rate=0.1, momentum=0.9,
                                    wd=0.01)),
    "adam_wd": ("Adam", dict(learning_rate=0.05, wd=0.01)),
    "adamw": ("AdamW", dict(learning_rate=0.05, wd=0.01)),
    "sgd_clip": ("SGD", dict(learning_rate=0.5, clip_gradient=0.05)),
    "lamb_wd": ("LAMB", dict(learning_rate=0.05, wd=0.01)),
}


def _jax_optimizer(mx, cls, kw):
    """The reference's optimizer for ``cls``. For LAMB, the optax chain its
    ``to_optax`` builds (``mxnet_tpu/parallel/learner.py:48-51``,
    ``optax.lamb``): that line reads ``beta1``/``beta2``/``epsilon`` off
    the optimizer, which the JAX package's ``LAMB`` does not keep, so the
    chain is given directly with LAMB's defaults."""
    if cls != "LAMB":
        return getattr(mx.optimizer, cls)(**kw)
    import optax

    return optax.lamb(kw["learning_rate"], b1=0.9, b2=0.999, eps=1e-6,
                      weight_decay=kw.get("wd", 0.0))


@pytest.mark.parametrize("case", sorted(_OPTIMIZERS))
def test_optimizers_match_the_reference(case, tmp_path):
    import mxnet_tpu as mx

    cls, kw = _OPTIMIZERS[case]
    rs = onp.random.RandomState(3)
    x = rs.randn(8, 6).astype("float32")
    y = rs.randint(0, 3, (8,)).astype("float32")
    tnet = _mlp(tmx)
    tnet.load_dict(_mlp_weights(tnet, 5))
    path = tmp_path / "mlp.params"
    tnet.save_parameters(str(path))
    jnet = _mlp(mx)
    jnet.load_parameters(str(path))
    jl = mx.parallel.Learner(jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             _jax_optimizer(mx, cls, kw),
                             mesh=_one_device_mesh())
    tl = tparallel.Learner(tnet, tgluon.loss.SoftmaxCrossEntropyLoss(),
                           getattr(tmx.optimizer, cls)(**kw))
    for _ in range(3):
        want = float(jl.step(mx.np.array(x), mx.np.array(y)))
        got = float(tl.step(tmx.np.array(x), tmx.np.array(y)))
        assert abs(got - want) <= RTOL * max(abs(want), 1.0), (got, want)
    jparams = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        assert _rel(_np(p), _np(jparams[n].data())) <= RTOL, n


def test_learner_data_parallel_step():
    """The reference's ``test_learner_data_parallel_step`` on one device:
    10 SGD steps with momentum lower the loss."""
    net = _mlp(tmx)
    net.initialize(seed=0)
    learner = tparallel.Learner(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                                tmx.optimizer.SGD(learning_rate=0.1,
                                                  momentum=0.9))
    trandom.seed(0)
    x = tmx.np.random.uniform(size=(16, 6))
    y = tmx.np.random.randint(0, 3, size=(16,)).astype("float32")
    losses = [float(learner.step(x, y)) for _ in range(10)]
    assert losses[-1] < losses[0], losses


def test_learner_matches_trainer():
    """The reference's ``test_learner_matches_trainer``: one Learner step
    equals an eager backward and an SGD ``Trainer`` step."""
    W = onp.random.RandomState(0).randn(3, 5).astype("float32") * 0.1

    def build():
        net = tgluon.nn.Dense(3, in_units=5, use_bias=False)
        net.initialize()
        net.load_dict({"weight": W})
        return net

    trandom.seed(1)
    x = tmx.np.random.uniform(size=(8, 5))
    y = tmx.np.random.randint(0, 3, size=(8,)).astype("float32")
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    net_a = build()
    trainer = tgluon.Trainer(net_a.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    with tag.record():
        loss = loss_fn(net_a(x), y).mean()
    loss.backward()
    trainer.step(1)
    net_b = build()
    tparallel.Learner(net_b, loss_fn,
                      tmx.optimizer.SGD(learning_rate=0.1)).step(x, y)
    assert _rel(_np(net_b.weight), _np(net_a.weight)) <= RTOL


# -- BERT pretraining, bench.py's model at a small width ------------------------
class _Padded:
    """``bench.py``'s ``_PaddedBERT`` in either package: a fixed valid
    length for every row (the key-padding mask)."""

    @staticmethod
    def make(pkg, inner, t_valid):
        class _PaddedBERT(pkg.gluon.HybridBlock):
            def __init__(self, inner, t_valid):
                super().__init__()
                self.inner = inner
                self._t_valid = t_valid

            def forward(self, tokens):
                vlen = pkg.np.full((tokens.shape[0],), self._t_valid,
                                   dtype="float32")
                return self.inner(tokens, None, vlen)

        return _PaddedBERT(inner, t_valid)


def _pretrain_loss(pkg):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def pretrain_loss(pair, labels):
        mlm_scores, nsp_scores = pair
        mlm_labels, nsp_labels = labels[:, :-1], labels[:, -1]
        return loss_fn(mlm_scores, mlm_labels).mean() + \
            loss_fn(nsp_scores, nsp_labels).mean()

    return pretrain_loss


def _bert_weights(shapes, seed=0):
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            a = 0.1 * rs.randn(*shape)
        else:
            a = 0.5 * rs.randn(*shape) / onp.sqrt(shape[-1]) ** 0.5
        out[name] = a.astype("float32")
    return out


def _port_bert(path=None, dropout=0.0):
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      BERTModel)

    model = _Padded.make(tmx, BERTForPretraining(
        BERTModel(**BERT_CFG, dropout=dropout, device="cpu"),
        vocab_size=VOCAB), T_VALID)
    if path is not None:
        model.load_parameters(str(path))
    return model


def _bert_batch(seed):
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, VOCAB, (B, T)).astype("int32")
    labels = onp.concatenate([rs.randint(0, VOCAB, (B, T)),
                              rs.randint(0, 2, (B, 1))], axis=1)
    return tokens, labels.astype("float32")


def _bf16_run(pkg, model, make_learner, batches):
    """Three steps after ``convert_hybrid_block``/``amp.init``: the losses,
    the weights before and after (float32 copies), and the first moment
    and its dtype for each trainable."""
    pkg.amp.convert_hybrid_block(model, "bfloat16")
    pkg.amp.init("bfloat16")
    try:
        params = model.collect_params()

        def weights():
            return {n: _np(p if pkg is tmx else p.data()).copy()
                    for n, p in params.items()}

        before = weights()
        learner = make_learner(model, _pretrain_loss(pkg))
        losses = [float(learner.step(pkg.np.array(tok), pkg.np.array(lab)))
                  for tok, lab in batches]
        if pkg is tmx:
            mu = next(st["mu"] for st in learner._opt_state if "mu" in st)
        else:
            mu = learner._opt_state[0].mu
        moments = {n: (_np(m), tmx.base.dtype_name(m.dtype))
                   if pkg is tmx else (onp.asarray(m, "float32"), str(m.dtype))
                   for n, m in zip(learner._param_names, mu)}
        return {"losses": losses, "before": before, "after": weights(),
                "mu": moments}
    finally:
        pkg.amp.disable()


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    """The JAX package's three AdamW steps of the small BERT in bf16, and
    the ``.params`` file both packages start from."""
    import mxnet_tpu as mx

    return _jax_bf16_reference(tmp_path_factory, lambda: mx.optimizer.AdamW(
        learning_rate=LR, wd=0.01))


@pytest.fixture(scope="module")
def bf16_lamb_reference(tmp_path_factory):
    """The same three steps through the reference's LAMB mapping
    (``optax.lamb``, see :func:`_jax_optimizer`)."""
    import mxnet_tpu as mx

    return _jax_bf16_reference(tmp_path_factory, lambda: _jax_optimizer(
        mx, "LAMB", dict(learning_rate=LR, wd=0.01)))


def _jax_bf16_reference(tmp_path_factory, make_optimizer):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.bert import (BERTForPretraining as JP,
                                                BERTModel as JB)

    with tmx.cpu():
        tmodel = _port_bert()
        tmodel.load_dict(_bert_weights({n: tuple(p.shape) for n, p in
                                        tmodel.collect_params().items()}))
        path = tmp_path_factory.mktemp("bert") / "bert.params"
        tmodel.save_parameters(str(path))
    jmodel = _Padded.make(mx, JP(JB(**BERT_CFG, dropout=0.0),
                                 vocab_size=VOCAB), T_VALID)
    jmodel.load_parameters(str(path))
    try:
        ref = _bf16_run(mx, jmodel, lambda m, lf: mx.parallel.Learner(
            m, lf, make_optimizer(), mesh=_one_device_mesh()),
            _BF16_BATCHES)
    finally:
        mx.amp.disable()
    return ref, path


_BF16_BATCHES = [_bert_batch(s) for s in range(3)]


def _bf16_faults(got, want):
    """Where the port's bf16 run departs from the reference's, as a list
    of messages (empty when it agrees):

    - each loss within ``BF16_TOL`` of the reference's;
    - each first moment in the reference's dtype (bf16 for a bf16 weight)
      and within ``MOMENT_TOL`` of the reference's largest entry: the
      moments carry the gradients, which bf16 rounds in another order in
      each package (measured: at most 0.07);
    - each weight's update ``after - before`` within ``UPDATE_TOL`` of the
      reference's update, in the Frobenius norm, over the entries whose
      reference first moment is at least ``NOISE_FLOOR`` of its tensor's
      largest. The others carry rounding noise as gradient (the attention
      key's bias, which softmax ignores): Adam moves them by +-lr a step
      with the noise's sign, in either package. At lr 1e-3 an update is
      about one bf16 step of the weight, so entries are compared as a
      whole (measured: at most 0.22); an update that is not applied
      scores 1."""
    faults = []
    for g, w in zip(got["losses"], want["losses"]):
        if abs(g - w) > BF16_TOL * abs(w):
            faults.append(f"loss {g} against {w}")
    for n, (mu_w, dt_w) in want["mu"].items():
        mu_g, dt_g = got["mu"][n]
        if dt_g != dt_w:
            faults.append(f"{n}: moment in {dt_g}, the reference's in {dt_w}")
        scale = float(abs(mu_w).max())
        if float(abs(mu_g - mu_w).max()) > MOMENT_TOL * scale:
            faults.append(f"{n}: first moment off by "
                          f"{float(abs(mu_g - mu_w).max()) / scale:.3f}")
        keep = abs(mu_w) >= NOISE_FLOOR * scale
        upd_w = (want["after"][n] - want["before"][n])[keep]
        upd_g = (got["after"][n] - got["before"][n])[keep]
        norm = float(onp.linalg.norm(upd_w))
        off = float(onp.linalg.norm(upd_g - upd_w))
        if norm and off > UPDATE_TOL * norm:
            faults.append(f"{n}: update off by {off / norm:.3f}")
    return faults


def _port_bf16_run(path, tx):
    model = _port_bert(path)
    return _bf16_run(tmx, model, lambda m, lf: tparallel.Learner(m, lf, tx),
                     _BF16_BATCHES)


def test_bert_pretraining_bf16_matches_the_reference(bf16_reference):
    ref, path = bf16_reference
    got = _port_bf16_run(path, tmx.optimizer.AdamW(learning_rate=LR,
                                                   wd=0.01))
    assert _bf16_faults(got, ref) == []
    assert {dt for _, dt in got["mu"].values()} == {"bfloat16", "float32"}


def test_bert_pretraining_bf16_lamb_matches_the_reference(
        bf16_lamb_reference):
    """LAMB's chain in bf16 (moments, norms, trust ratios), held by the
    AdamW comparison's bounds (``_bf16_faults``; measured: first moments
    within 0.059, updates within 0.247 against 0.15 and 0.35). The trust
    ratio rescales each tensor's update to about ``lr |w|``, some 1/64 of
    AdamW's at these widths, so an AdamW in its place fails them."""
    ref, path = bf16_lamb_reference
    got = _port_bf16_run(path, tmx.optimizer.LAMB(learning_rate=LR,
                                                  wd=0.01))
    assert _bf16_faults(got, ref) == []
    assert {dt for _, dt in got["mu"].values()} == {"bfloat16", "float32"}


class _Fp32Adam(learner_mod._ScaleByAdam):
    """Adam with float32 moments and a float32 update over bf16 weights:
    the port's fused ``AdamW``, not optax's."""

    def init(self, params):
        return super().init([p.float() for p in params])

    def update(self, updates, state, params):
        return super().update([u.float() for u in updates], state, params)


_FAULTY = {
    "no_update": lambda: learner_mod.GradientTransformation(
        learner_mod._ScaleByAdam(0.9, 0.999, 1e-8),
        learner_mod._ScaleByLearningRate(0.0)),
    "fp32_moments": lambda: learner_mod.GradientTransformation(
        _Fp32Adam(0.9, 0.999, 1e-8), learner_mod._AddDecayedWeights(0.01),
        learner_mod._ScaleByLearningRate(LR)),
}


@pytest.mark.parametrize("fault", sorted(_FAULTY))
def test_bf16_comparison_rejects_a_faulty_update(fault, bf16_reference):
    """The bounds above catch a step that applies no update and an AdamW
    that keeps its moments (and computes its update) in float32."""
    ref, path = bf16_reference
    assert _bf16_faults(_port_bf16_run(path, _FAULTY[fault]()), ref)


def _twin_runs(remat_flags, steps=2, dropout=0.1, seed=4):
    """The same BERT, weights and batches through Learners with the given
    remat flags, each from ``random.seed(seed)``; returns the losses and
    final weights of each run."""
    out = []
    weights = None
    for remat in remat_flags:
        model = _port_bert(dropout=dropout)
        if weights is None:
            weights = _bert_weights({n: tuple(p.shape) for n, p in
                                     model.collect_params().items()}, 2)
        model.load_dict(weights)
        learner = tparallel.Learner(
            model, _pretrain_loss(tmx),
            tmx.optimizer.AdamW(learning_rate=1e-3, wd=0.01), remat=remat)
        trandom.seed(seed)
        losses = [learner.step(*(tmx.np.array(a) for a in _bert_batch(s)))
                  for s in range(steps)]
        out.append(([float(v) for v in losses],
                    {n: p.detach().clone()
                     for n, p in model.collect_params().items()}))
    return out


def test_remat_equals_plain_bitwise():
    (plain_l, plain_w), (remat_l, remat_w) = _twin_runs([False, True])
    assert plain_l == remat_l
    for n, w in plain_w.items():
        assert torch.equal(w, remat_w[n]), n
    # dropout draws: another seed gives another loss
    (other_l, _), = _twin_runs([True], seed=5)
    assert other_l[0] != remat_l[0]


def test_remat_recompute_draws_the_forwards_masks():
    """Without restoring the port's generator around the recompute the
    masks would differ: the step advances the generator by the forward's
    draws only, once."""
    model = _port_bert(dropout=0.1)
    model.initialize(seed=1)
    learner = tparallel.Learner(model, _pretrain_loss(tmx),
                                tmx.optimizer.SGD(learning_rate=0.1),
                                remat=True)
    gen = trandom.generator("cpu")
    trandom.seed(9)
    learner.step(*(tmx.np.array(a) for a in _bert_batch(0)))
    after_remat = gen.get_state()
    model2 = _port_bert(dropout=0.1)
    model2.initialize(seed=1)
    plain = tparallel.Learner(model2, _pretrain_loss(tmx),
                              tmx.optimizer.SGD(learning_rate=0.1))
    trandom.seed(9)
    plain.step(*(tmx.np.array(a) for a in _bert_batch(0)))
    assert torch.equal(gen.get_state(), after_remat)


def test_checkpoint_round_trip(tmp_path):
    net = tgluon.nn.HybridSequential()
    net.add(tgluon.nn.Dense(8, in_units=6), tgluon.nn.BatchNorm(in_channels=8),
            tgluon.nn.Dense(3, in_units=8))
    net.initialize(seed=2)
    learner = tparallel.Learner(net, tgluon.loss.SoftmaxCrossEntropyLoss(),
                                tmx.optimizer.Adam(learning_rate=0.01))
    with pytest.raises(MXNetError, match="has not traced yet"):
        learner.save_checkpoint(str(tmp_path / "ck"))
    rs = onp.random.RandomState(0)
    x = tmx.np.array(rs.randn(8, 6).astype("float32"))
    y = tmx.np.array(rs.randint(0, 3, (8,)).astype("float32"))
    learner.step(x, y)
    learner.save_checkpoint(str(tmp_path / "ck"))
    saved = {k: v.detach().clone()
             for k, v in learner._checkpoint_tree().items()}
    assert any(k.startswith("aux/") and "running_mean" in k for k in saved)
    assert any(k.startswith("opt_state/") and "/mu/" in k for k in saved)
    first = float(learner.step(x, y))
    learner.step(x, y)
    learner.restore_checkpoint(str(tmp_path / "ck"))
    for k, v in learner._checkpoint_tree().items():
        assert torch.equal(v, saved[k]), k
    assert float(learner.step(x, y)) == first


def test_mesh_or_param_spec_raises_naming_a8():
    net = _mlp(tmx)
    net.initialize(seed=0)
    loss = tgluon.loss.L2Loss()
    opt = tmx.optimizer.SGD(learning_rate=0.1)
    with pytest.raises(MXNetError, match="A8"):
        tparallel.Learner(net, loss, opt, mesh=object())
    with pytest.raises(MXNetError, match="A8"):
        tparallel.Learner(net, loss, opt,
                          param_spec_fn=lambda name, shape: None)


def test_unmapped_optimizers_raise():
    net = _mlp(tmx)
    net.initialize(seed=0)
    loss = tgluon.loss.L2Loss()
    with pytest.raises(MXNetError, match="no optax mapping for NAG"):
        tparallel.Learner(net, loss, tmx.optimizer.NAG(learning_rate=0.1))
    with pytest.raises(MXNetError, match="no optax mapping for RMSProp"):
        tparallel.Learner(net, loss, tmx.optimizer.RMSProp())


def test_deferred_shapes_settle_before_the_step():
    net = tgluon.nn.HybridSequential()
    net.add(tgluon.nn.Dense(5, activation="relu"), tgluon.nn.Dense(2))
    net.initialize(seed=3)
    learner = tparallel.Learner(net, tgluon.loss.L2Loss(),
                                tmx.optimizer.SGD(learning_rate=0.1))
    x = torch.randn(4, 7)
    y = torch.randn(4, 2)
    l0 = float(learner.step(x, y))
    assert net[0].weight.shape == (5, 7)
    assert float(learner.step(x, y)) < l0
    assert learner._traces == 1
    learner.step(torch.randn(3, 7), torch.randn(3, 2))
    assert learner._traces == 2     # a new signature builds anew


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_step_replays_and_matches_eager_on_the_card(cuda):
    """One capture a signature; a replayed step bitwise equal to the same
    step run eagerly from the same state (dropout 0)."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      BERTModel)

    with tmx.gpu():
        model = _Padded.make(tmx, BERTForPretraining(
            BERTModel(**BERT_CFG, dropout=0.0, device=cuda),
            vocab_size=VOCAB), T_VALID)
        model.initialize(seed=3)
        learner = tparallel.Learner(
            model, _pretrain_loss(tmx),
            tmx.optimizer.AdamW(learning_rate=1e-3, wd=0.01))
        tok, lab = (tmx.np.array(a) for a in _bert_batch(0))
        learner.step(tok, lab)                  # warm step and capture
        tree = learner._checkpoint_tree()
        start = {k: v.detach().clone() for k, v in tree.items()}
        replayed = learner.step(tok, lab)
        after = {k: v.detach().clone() for k, v in tree.items()}
        with torch.no_grad():
            for k, v in tree.items():
                v.copy_(start[k])
        eager = learner._run_eager(tok, lab)
        torch.cuda.synchronize()
        assert learner._captures == 1
        assert learner.graph_stats()[0]["replays"] == 1
        assert torch.equal(replayed._data, eager._data)
        for k, v in tree.items():
            assert torch.equal(v, after[k]), k


@pytest.mark.cuda
def test_remat_under_capture_draws_the_forwards_masks(cuda):
    """Captured steps with remat and dropout 0.1 against plain captured
    steps from the same seed: the same losses and weights after three
    steps (two replays), so the recompute inside the graph drew the
    forward's masks."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      BERTModel)

    runs = []
    with tmx.gpu():
        for remat in (False, True):
            model = _Padded.make(tmx, BERTForPretraining(
                BERTModel(**BERT_CFG, dropout=0.1, device=cuda),
                vocab_size=VOCAB), T_VALID)
            model.initialize(seed=4)
            learner = tparallel.Learner(
                model, _pretrain_loss(tmx),
                tmx.optimizer.AdamW(learning_rate=1e-3, wd=0.01),
                remat=remat)
            trandom.seed(6)
            tok, lab = (tmx.np.array(a) for a in _bert_batch(1))
            losses = [float(learner.step(tok, lab)) for _ in range(3)]
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
