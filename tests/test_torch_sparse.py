"""PyTorch/CUDA port: CSR and row-sparse arrays, ``sparse.dot``,
``LibSVMIter`` / ``CSVIter``, the optimizers' lazy row-sparse updates and
the ``Trainer``'s routing of row-sparse gradients, against the JAX package
on the CPU.

Checked, each with its tolerance:

- ``csr_matrix`` / ``row_sparse_array`` / ``tostype`` round trips, CSR
  ``slice`` and indexing, ``retain``: exactly the reference's arrays;
- ``sparse.dot`` (1-D and 2-D dense operands, with and without
  ``transpose_a``) and the dense operand's gradient: within 1e-6 of each
  largest entry (sums in another order);
- ``LibSVMIter`` (dense and ``sparse=True``, ``pad`` and ``discard``,
  features past ``data_shape`` dropped) and ``CSVIter`` on the same
  temporary files: batches, labels and ``pad`` exactly the reference's;
  the vectorised ``_row_entries`` equal to the reference's per-row one;
  the native parser took the files;
- each lazy update (SGD, AdaGrad, Adam, Ftrl, GroupAdaGrad) and the
  densifying ones (SGD with momentum, ``lazy_update=False``, AdamW), 3
  steps with unsorted indices that repeat, ``rescale_grad`` and
  ``clip_gradient``: weights and states within 1e-6 of each largest entry,
  rows outside the gradient bitwise unchanged, ``todense`` never called on
  a lazy path; bf16 under ``multi_precision``: masters within 1e-6, the
  weight the master's rounding; the registered ``sparse_*_update`` ops;
- a ``Trainer`` over a parameter with a row-sparse gradient beside a dense
  one: the reference's ``Trainer`` on the same values, within 1e-6;
- ``tests/torch_script_sparse.py`` (``examples/sparse_linear.py``, imports
  changed) trains to the example's accuracy (> 0.9) on its own set.

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_sparse.py -m cuda`` collects this
file on a machine without JAX.
"""
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Parameter, Trainer
from mxnet_tpu_torch.io import _textparse
from mxnet_tpu_torch.ndarray import sparse as tsp

DOT_RTOL = 1e-6
OPT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max(initial=0.0) /
                 max(abs(want).max(initial=0.0), 1e-30))


def _sparse_dense(rng, shape, density=0.3):
    a = rng.randn(*shape).astype("float32")
    a[rng.uniform(size=shape) > density] = 0
    return a


# -- arrays ------------------------------------------------------------------
def test_csr_round_trip_matches_reference():
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.ndarray import sparse as jsp

    rng = onp.random.RandomState(0)
    dense = _sparse_dense(rng, (7, 9))
    dense[3] = 0                                  # an empty row
    j, t = jsp.csr_matrix(dense), tsp.csr_matrix(dense)
    for part in ("data", "indices", "indptr"):
        onp.testing.assert_array_equal(getattr(t, part).asnumpy(),
                                       getattr(j, part).asnumpy())
    onp.testing.assert_array_equal(t._rows().asnumpy(), j._rows().asnumpy())
    onp.testing.assert_array_equal(t.todense().asnumpy(), dense)
    assert t.stype == "csr" and t.shape == (7, 9) and t.nnz == j.nnz
    for a, b in ((2, 6), (0, 7), (3, 4)):
        onp.testing.assert_array_equal(t[a:b].todense().asnumpy(),
                                       j[a:b].todense().asnumpy())
        onp.testing.assert_array_equal(t[a:b].indptr.asnumpy(),
                                       j[a:b].indptr.asnumpy())
    onp.testing.assert_array_equal(t[5].asnumpy(), j[5].asnumpy())
    via = tnp.array(dense).tostype("csr")
    onp.testing.assert_array_equal(via.todense().asnumpy(), dense)
    triple = tsp.csr_matrix((j.data.asnumpy(), j.indices.asnumpy(),
                             j.indptr.asnumpy()), shape=(7, 9))
    onp.testing.assert_array_equal(triple.todense().asnumpy(), dense)
    # a column past the shape is dropped by todense, as the reference's
    odd = (onp.ones(3, "float32"), [1, 9, 2], [0, 2, 3])
    onp.testing.assert_array_equal(
        tsp.csr_matrix(odd, shape=(2, 9)).todense().asnumpy(),
        jsp.csr_matrix(odd, shape=(2, 9)).todense().asnumpy())
    del jnp_


def test_row_sparse_round_trip_matches_reference():
    from mxnet_tpu.ndarray import sparse as jsp

    rng = onp.random.RandomState(1)
    dense = rng.randn(8, 3).astype("float32")
    dense[[0, 2, 5]] = 0
    j, t = jsp.row_sparse_array(dense), tsp.row_sparse_array(dense)
    onp.testing.assert_array_equal(t.indices.asnumpy(), j.indices.asnumpy())
    onp.testing.assert_array_equal(t.data.asnumpy(), j.data.asnumpy())
    onp.testing.assert_array_equal(t.todense().asnumpy(), dense)
    onp.testing.assert_array_equal(
        tnp.array(dense).tostype("row_sparse").todense().asnumpy(), dense)
    keep = [7, 1, 3, 2]
    onp.testing.assert_array_equal(t.retain(keep).indices.asnumpy(),
                                   j.retain(keep).indices.asnumpy())
    onp.testing.assert_array_equal(t.retain(keep).todense().asnumpy(),
                                   j.retain(keep).todense().asnumpy())
    # repeated rows: the last one wins, as the reference's scatter
    rows = rng.randn(3, 3).astype("float32")
    dup_t = tsp.RowSparseNDArray(rows, [4, 1, 4], (6, 3))
    dup_j = jsp.RowSparseNDArray(rows, [4, 1, 4], (6, 3))
    onp.testing.assert_array_equal(dup_t.todense().asnumpy(),
                                   dup_j.todense().asnumpy())
    assert tnp.array(dense).tostype("default").shape == (8, 3)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("cols", [None, 3])
def test_dot_forward_and_backward_match_reference(transpose_a, cols):
    """sparse.dot and the dense operand's gradient of sum(c * out)."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.ndarray import sparse as jsp

    rng = onp.random.RandomState(2)
    dense = _sparse_dense(rng, (6, 10))
    k = 6 if transpose_a else 10
    rhs = rng.randn(*((k,) if cols is None else (k, cols))).astype("float32")
    n_out = 10 if transpose_a else 6
    c = rng.randn(*((n_out,) if cols is None else (n_out, cols))) \
        .astype("float32")
    res = []
    for sp, np_, ag in ((jsp, jnp_, jag), (tsp, tnp, tag)):
        a = sp.csr_matrix(dense)
        w = np_.array(rhs)
        w.attach_grad()
        with ag.record():
            out = sp.dot(a, w, transpose_a=transpose_a)
            loss = (out * np_.array(c)).sum()
        loss.backward()
        res.append((out.asnumpy(), w.grad.asnumpy()))
    want = (dense.T if transpose_a else dense) @ rhs
    assert _rel(res[1][0], res[0][0]) <= DOT_RTOL
    assert _rel(res[1][0], want) <= DOT_RTOL
    assert _rel(res[1][1], res[0][1]) <= DOT_RTOL


# -- iterators -----------------------------------------------------------------
def _libsvm_file(tmp_path, rows=11, feats=8, seed=7):
    rng = onp.random.RandomState(seed)
    lines = []
    for i in range(rows):
        cols = sorted(rng.choice(feats + 3, 3, replace=False))  # some >= feats
        lines.append(f"{i % 2} " + " ".join(
            f"{c}:{rng.randn():.3f}" for c in cols))
    lines[4] = "1"                                   # a row with no entries
    path = tmp_path / "t.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _batches(it):
    out = []
    for b in it:
        d = b.data[0]
        out.append((d.todense().asnumpy() if hasattr(d, "todense") else
                    d.asnumpy(), b.label[0].asnumpy(), b.pad,
                    getattr(d, "stype", "default")))
    return out


@pytest.mark.parametrize("handle", ["pad", "discard"])
@pytest.mark.parametrize("sparse", [False, True])
def test_libsvm_iter_matches_reference(tmp_path, handle, sparse):
    from mxnet_tpu import io as jio

    path = _libsvm_file(tmp_path)
    before = _textparse.counts()["libsvm_native"]
    kw = dict(data_shape=(8,), batch_size=4, last_batch_handle=handle,
              sparse=sparse)
    t_it, j_it = tio.LibSVMIter(path, **kw), jio.LibSVMIter(path, **kw)
    assert _textparse.counts()["libsvm_native"] == before + 1
    got, want = _batches(t_it), _batches(j_it)
    assert len(got) == len(want) == (3 if handle == "pad" else 2)
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g[0], w[0])
        onp.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[3] == w[3]
    t_it.reset()
    assert len(_batches(t_it)) == len(got)
    for a, b in zip(t_it.csr, j_it.csr):
        onp.testing.assert_array_equal(a, b)


def test_libsvm_row_entries_vectorised(tmp_path):
    """The vectorised gather equals the reference's per-row one, on rows
    in order, wrapped (the padded batch) and out of order."""
    from mxnet_tpu import io as jio

    path = _libsvm_file(tmp_path, rows=40, seed=3)
    t_it = tio.LibSVMIter(path, data_shape=(8,), batch_size=4)
    j_it = jio.LibSVMIter(path, data_shape=(8,), batch_size=4)
    for rows in (onp.arange(8, 16), onp.array([38, 39, 0, 1]),
                 onp.array([5, 2, 4, 4, 30]), onp.arange(0)):
        for a, b in zip(t_it._row_entries(rows), j_it._row_entries(rows)):
            onp.testing.assert_array_equal(a, b)


def test_csv_iter_matches_reference(tmp_path):
    from mxnet_tpu import io as jio

    rng = onp.random.RandomState(4)
    data, label = rng.randn(10, 6).astype("float32"), rng.randint(0, 3, 10)
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    onp.savetxt(dpath, data, delimiter=",", fmt="%.5f")
    onp.savetxt(lpath, label, delimiter=",", fmt="%d")
    before = _textparse.counts()["csv_native"]
    kw = dict(data_shape=(2, 3), label_csv=str(lpath), batch_size=4)
    got = _batches(tio.CSVIter(str(dpath), **kw))
    want = _batches(jio.CSVIter(str(dpath), **kw))
    assert _textparse.counts()["csv_native"] == before + 2
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            onp.testing.assert_array_equal(a, b)
    # a ragged row makes the native scanner bail: the strict numpy parse
    # reports it, as the reference's does
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        tio.CSVIter(str(bad), data_shape=(3,))
    assert _textparse.counts()["csv_numpy"] >= 1


# -- lazy updates ------------------------------------------------------------------
ROWS, DIM = 9, 3
IDX = [[6, 1, 4, 1], [0, 8, 3, 8], [4, 6, 7, 2]]   # unsorted, repeated


def _jax_rs(vals, idx):
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.ndarray.sparse import RowSparseNDArray

    return RowSparseNDArray(NDArray(vals), NDArray(onp.array(idx, "int32")),
                            (ROWS, DIM))


OPTS = [("sgd", {}, True), ("adagrad", {"wd": 0.01}, True),
        ("adam", {"wd": 0.01}, True), ("ftrl", {"wd": 0.01}, True),
        ("groupadagrad", {}, True),
        ("sgd", {"momentum": 0.9, "wd": 0.01}, False),
        ("sgd", {"lazy_update": False, "wd": 0.5}, False),
        ("adam", {"lazy_update": False}, False),
        ("adamw", {"wd": 0.1}, False)]


@pytest.mark.parametrize("name,kw,lazy", OPTS,
                         ids=[f"{n}-{'-'.join(k) or 'lazy'}"
                              for n, k, _ in OPTS])
def test_row_sparse_update_matches_reference(name, kw, lazy, monkeypatch):
    from mxnet_tpu import np as jnp_
    from mxnet_tpu import optimizer as jopt

    rng = onp.random.RandomState(5)
    w0 = rng.randn(ROWS, DIM).astype("float32")
    grads = [rng.randn(len(i), DIM).astype("float32") for i in IDX]
    kw = dict(kw, learning_rate=0.1, rescale_grad=0.5, clip_gradient=0.8)
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw, tw = jnp_.array(w0), torch.tensor(w0)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    dense_calls = []
    real = tsp.RowSparseNDArray.todense
    monkeypatch.setattr(tsp.RowSparseNDArray, "todense",
                        lambda self: dense_calls.append(1) or real(self))
    for g, idx in zip(grads, IDX):
        jo.update(0, jw, _jax_rs(g, idx), js)
        before = tw.clone()
        to.update(0, tw, tsp.RowSparseNDArray(g, idx, (ROWS, DIM)), ts)
        if lazy:
            untouched = sorted(set(range(ROWS)) - set(idx))
            assert torch.equal(tw[untouched], before[untouched])
    assert bool(dense_calls) != lazy
    assert _rel(tw.numpy(), jw.asnumpy()) <= OPT_RTOL
    for k in js:
        assert _rel(ts[k].numpy(), js[k].asnumpy()) <= OPT_RTOL, k


def test_row_sparse_update_multi_precision():
    """bf16 weight under multi_precision: the fp32 master takes the lazy
    step and the touched rows are rounded into the weight; a dense step
    after it keeps the sparse rows' progress (reference
    test_sparse_grad_multi_precision_master_stays_current)."""
    from mxnet_tpu import np as jnp_
    from mxnet_tpu import optimizer as jopt

    rng = onp.random.RandomState(6)
    w0 = rng.randn(ROWS, DIM).astype("float32")
    g = rng.randn(4, DIM).astype("float32")
    kw = dict(learning_rate=0.1, multi_precision=True)
    jo, to = jopt.create("adam", **kw), topt.create("adam", **kw)
    jw = jnp_.array(w0).astype("bfloat16")
    tw = torch.tensor(w0).to(torch.bfloat16)
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    before = tw.clone()
    jo.update_multi_precision(0, jw, _jax_rs(g, IDX[0]), js)
    to.update_multi_precision(0, tw, tsp.RowSparseNDArray(g, IDX[0],
                                                          (ROWS, DIM)), ts)
    untouched = sorted(set(range(ROWS)) - set(IDX[0]))
    assert torch.equal(tw[untouched], before[untouched])
    assert _rel(ts["weight_fp32"].numpy(),
                js["weight_fp32"].asnumpy()) <= OPT_RTOL
    assert torch.equal(tw, ts["weight_fp32"].to(torch.bfloat16))
    gd = rng.randn(ROWS, DIM).astype("float32")
    jo.update_multi_precision(0, jw, jnp_.array(gd).astype("bfloat16"), js)
    to.update_multi_precision(0, tw, torch.tensor(gd).to(torch.bfloat16), ts)
    assert _rel(ts["weight_fp32"].numpy(),
                js["weight_fp32"].asnumpy()) <= OPT_RTOL


SPARSE_OPS = [("sparse_sgd_update", 1, dict(lr=0.1, wd=0.01)),
              ("sparse_adagrad_update", 2, dict(lr=0.1, wd=0.01)),
              ("sparse_adam_update", 3, dict(lr=0.1, t=2.0,
                                             clip_gradient=0.5)),
              ("sparse_ftrl_update", 3, dict(lr=0.1, wd=0.01)),
              ("group_adagrad_update", 2, dict(lr=0.1))]


@pytest.mark.parametrize("name,n_state,attrs", SPARSE_OPS,
                         ids=[c[0] for c in SPARSE_OPS])
def test_registered_sparse_ops_match_reference(name, n_state, attrs):
    from mxnet_tpu.ndarray.ndarray import NDArray as JND
    from mxnet_tpu.ops import apply_op as japply

    from mxnet_tpu_torch.ops import apply_op as tapply

    rng = onp.random.RandomState(8)
    w = rng.randn(ROWS, DIM).astype("float32")
    states = [onp.abs(rng.randn(*((ROWS,) if name.startswith("group")
                                  else (ROWS, DIM)))).astype("float32")
              for _ in range(n_state - 1)]
    if name.startswith("group"):
        args = [w, *states, rng.randn(ROWS, DIM).astype("float32")]
    else:
        args = [w, *states, rng.randn(4, DIM).astype("float32"),
                onp.array(IDX[0], "int32")]
    want = japply(name, *[JND(a) for a in args], **attrs)
    got = tapply(name, *[tnp.array(a) for a in args], **attrs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, wnt in zip(got, want):
        assert _rel(g.asnumpy(), wnt.asnumpy()) <= OPT_RTOL


def test_trainer_routes_row_sparse_gradient():
    """A parameter whose gradient is row-sparse leaves the fused buckets
    and takes the lazy path; its dense neighbour is fused. Against the
    reference's Trainer on the same values."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import Parameter as JParameter

    rng = onp.random.RandomState(9)
    emb0 = rng.randn(ROWS, DIM).astype("float32")
    dense0 = rng.randn(4, DIM).astype("float32")
    jp = [JParameter("emb", shape=(ROWS, DIM)),
          JParameter("dense", shape=(4, DIM))]
    for p, v in zip(jp, (emb0, dense0)):
        p.initialize()
        p.set_data(jnp_.array(v))
    tp = [Parameter(torch.tensor(emb0)), Parameter(torch.tensor(dense0))]
    kw = {"learning_rate": 0.1, "wd": 0.01}
    jtr = jgluon.Trainer(jp, "adam", kw)
    ttr = Trainer(tp, "adam", kw)
    for idx in IDX:
        g = rng.randn(len(idx), DIM).astype("float32")
        gd = rng.randn(4, DIM).astype("float32")
        jp[0]._data._grad = _jax_rs(g, idx)
        jp[1]._data._grad._set_data(jnp_.array(gd)._data)
        tp[0].grad = tsp.RowSparseNDArray(g, idx, (ROWS, DIM))
        tp[1].grad = torch.tensor(gd)
        before = tp[0].detach().clone()
        jtr.step(2)
        ttr.step(2)
        untouched = sorted(set(range(ROWS)) - set(idx))
        assert torch.equal(tp[0].detach()[untouched], before[untouched])
    assert isinstance(tp[0].grad, tsp.RowSparseNDArray)
    assert ttr._fused_dispatches == 3 and ttr._fused_traces == 1
    for p, q in zip(tp, jp):
        assert _rel(p.detach().numpy(), q.data().asnumpy()) <= OPT_RTOL
    tp[0].zero_grad()
    assert not isinstance(tp[0].grad, tsp.RowSparseNDArray)


def test_dense_backward_after_row_sparse_step():
    """A backward after a row-sparse step writes the parameter's one
    gradient slot: the next step applies the dense gradient, not the old
    sparse one again. Against the reference's ``Trainer`` given the same
    two gradients (its backward raises over a row-sparse slot, so its
    parameter gets the dense gradient the port's backward computes)."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import Parameter as JParameter
    from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

    rng = onp.random.RandomState(11)
    w0 = rng.randn(ROWS, DIM).astype("float32")
    g = rng.randn(len(IDX[0]), DIM).astype("float32")
    c = rng.randn(ROWS, DIM).astype("float32")
    jp = JParameter("emb", shape=(ROWS, DIM))
    jp.initialize()
    jp.set_data(jnp_.array(w0))
    tp = Parameter(torch.tensor(w0))
    kw = {"learning_rate": 0.1}
    jtr = jgluon.Trainer([jp], "adam", kw)
    ttr = Trainer([tp], "adam", kw)
    jp._data._grad = _jax_rs(g, IDX[0])
    tp.grad = tsp.RowSparseNDArray(g, IDX[0], (ROWS, DIM))
    jtr.step(1)
    ttr.step(1)
    with tag.record():
        loss = (tp.data() * tnp.array(c)).sum()
    loss.backward()
    assert not isinstance(tp.grad, tsp.RowSparseNDArray)
    onp.testing.assert_array_equal(tp.grad.numpy(), c)
    jp._data._grad = JNDArray(c)
    jtr.step(1)
    ttr.step(1)
    assert _rel(tp.detach().numpy(), jp.data().asnumpy()) <= OPT_RTOL


def test_sparse_linear_script_trains(monkeypatch):
    """tests/torch_script_sparse.py, the reference's example with its
    imports changed, fits its synthetic set (the example's own assert)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_script_sparse

    monkeypatch.setattr(sys, "argv", ["torch_script_sparse.py"])

    acc, losses = torch_script_sparse.main()
    assert acc > 0.9, acc
    assert losses[-1] < losses[0]


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sparse_linear_on_card(cuda, tmp_path):
    """(i) at a small size: the example's loop on the card, its losses
    within 1e-5 of the CPU's and its accuracy the example's."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_script_sparse

    path = str(tmp_path / "s.libsvm")
    d = torch_script_sparse.make_synthetic(path, n=256, d=50)
    acc_c, losses_c = torch_script_sparse.main(path, d, epochs=5)
    with tmx.gpu():
        acc_g, losses_g = torch_script_sparse.main(path, d, epochs=5)
    assert _rel(losses_g, losses_c) <= 1e-5
    assert acc_g > 0.9 and abs(acc_g - acc_c) <= 1 / 256


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam", "ftrl",
                                  "groupadagrad"])
def test_lazy_update_on_card(cuda, name):
    """(ii) at a small size: the lazy update on the card against the CPU,
    untouched rows bitwise."""
    rng = onp.random.RandomState(10)
    w0 = rng.randn(1000, 8).astype("float32")
    steps = [(rng.choice(1000, 50, replace=False),
              rng.randn(50, 8).astype("float32")) for _ in range(3)]
    out = []
    for dev in ("cpu", cuda):
        opt = topt.create(name, learning_rate=0.1)
        w = torch.tensor(w0, device=dev)
        st = opt.create_state(0, w)
        for idx, g in steps:
            opt.update(0, w, tsp.RowSparseNDArray(g, idx, (1000, 8),
                                                  ctx=dev), st)
        out.append((w.cpu(), {k: v.cpu() for k, v in st.items()}))
    touched = {int(i) for idx, _ in steps for i in idx}
    untouched = sorted(set(range(1000)) - touched)
    (wc, sc), (wg, sg) = out
    assert torch.equal(wg[untouched], torch.tensor(w0)[untouched])
    assert _rel(wg.numpy(), wc.numpy()) <= OPT_RTOL
    for k in sc:
        assert _rel(sg[k].numpy(), sc[k].numpy()) <= OPT_RTOL, k


@pytest.mark.cuda
def test_csr_dot_on_card(cuda):
    rng = onp.random.RandomState(11)
    dense = _sparse_dense(rng, (64, 500), 0.05)
    rhs = rng.randn(500).astype("float32")
    outs = []
    for ctx in (tmx.cpu(), tmx.gpu()):
        with ctx:
            a = tsp.csr_matrix(dense)
            w = tnp.array(rhs)
            w.attach_grad()
            with tag.record():
                out = tsp.dot(a, w)
                loss = (out * out).sum()
            loss.backward()
            outs.append((out.asnumpy(), w.grad.asnumpy()))
    assert _rel(outs[1][0], outs[0][0]) <= 1e-5
    assert _rel(outs[1][1], outs[0][1]) <= 1e-5
