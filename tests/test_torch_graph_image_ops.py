"""PyTorch/CUDA port: ``ops/graph_image_ops.py``'s 40 names against the JAX
package, on the CPU.

- Sliding-window attention: ``sldwin_atten_score`` and ``_context``
  forward, and their vjps against ``jax.vjp`` of the reference's op, with
  dilation per head (1, 2, 3), symmetric and causal, within ``RTOL`` (1e-5
  of each output's largest entry: the band's products are summed in
  another order); ``_mask_like`` bitwise; the port's gather in chunks of
  rows bitwise equal to one chunk.
- The DGL ops: ``dgl_adjacency``, ``dgl_subgraph`` (with and without the
  edge mapping, a repeated vertex among the ids), ``dgl_graph_compact``,
  ``edge_id`` and ``getnnz`` bitwise. The neighbour samplers seed from the
  port's own generator (the reference's seed comes from its JAX key), so
  they are held by structure: the seeds first, hop offsets that count the
  vertices, no vertex twice, -1 padding, each vertex of a hop a neighbour
  of the hop before, no vertex of zero probability, and one
  ``mx.random.seed`` giving one sample.
- The image and cv ops bitwise after the same ``mx.random.seed``; the
  eager ones raise inside a hybridized block, where ``image_to_tensor`` and
  ``image_normalize`` run.
- Every name and its alias are one op.

The ``cuda`` tests hold the same ops on the card against the CPU: the band
ops within ``RTOL``, the rest bitwise.
"""
import io

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import graph_image_ops as gio
from mxnet_tpu_torch.ops import registry as treg

RTOL = 1e-5
BAND = dict(B=2, L=24, H=3, D=8, w=4)
DILATION = onp.array([1, 2, 3], "int32")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else onp.asarray(x)


def _band_inputs(seed=0):
    rs = onp.random.RandomState(seed)
    b, l_, h, d, w = (BAND[k] for k in ("B", "L", "H", "D", "w"))
    qkv = [rs.randn(b, l_, h, d).astype("float32") for _ in range(3)]
    widths = {True: 2 * w + 1, False: w + 1}
    scores = {s: rs.randn(b, l_, h, widths[s]).astype("float32")
              for s in widths}
    grads = {s: (rs.randn(b, l_, h, widths[s]).astype("float32"),
                 rs.randn(b, l_, h, d).astype("float32")) for s in widths}
    return qkv, scores, grads


def _port_band(name, symmetric, a, b, dil=DILATION, device="cpu"):
    """(out, grads of a and b) of the port's op for the output cotangent
    given by the caller through ``.backward``."""
    fn = treg.get_op(name).fn(w=BAND["w"], symmetric=symmetric)
    ta = torch.tensor(a, device=device, requires_grad=True)
    tb = torch.tensor(b, device=device, requires_grad=True)
    return fn(ta, tb, torch.tensor(dil, device=device)), ta, tb


@pytest.mark.parametrize("symmetric", [True, False])
def test_sldwin_score_and_context_match_the_reference_with_vjps(symmetric):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    (q, k, v), scores, grads = _band_inputs()
    dil = jnp.asarray(DILATION)
    g_score, g_ctx = grads[symmetric]
    for name, a, b, g in (("sldwin_atten_score", q, k, g_score),
                          ("sldwin_atten_context", scores[symmetric], v,
                           g_ctx)):
        jf = jreg.get_op(name).fn(w=BAND["w"], symmetric=symmetric)
        want, vjp = jax.vjp(lambda x, y: jf(x, y, dil), jnp.asarray(a),
                            jnp.asarray(b))
        da, db = vjp(jnp.asarray(g))
        out, ta, tb = _port_band(name, symmetric, a, b)
        out.backward(torch.tensor(g))
        assert _rel(_np(out), want) <= RTOL, name
        assert _rel(_np(ta.grad), da) <= RTOL, name
        assert _rel(_np(tb.grad), db) <= RTOL, name
    # out-of-band entries are exact zeros, as are their gradients
    out, _, _ = _port_band("sldwin_atten_score", symmetric, q, k)
    mask = treg.get_op("sldwin_atten_mask_like").fn(
        w=BAND["w"], symmetric=symmetric)(
        out, torch.tensor(DILATION), torch.tensor([BAND["L"]] * BAND["B"]))
    assert bool((out.detach()[mask == 0] == 0).all())


@pytest.mark.parametrize("symmetric", [True, False])
def test_sldwin_mask_like_is_the_reference_bitwise(symmetric):
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    _, scores, _ = _band_inputs()
    s = scores[symmetric]
    vl = onp.array([17, 24], "int32")
    want = jreg.get_op("sldwin_atten_mask_like").fn(
        w=BAND["w"], symmetric=symmetric)(jnp.asarray(s),
                                          jnp.asarray(DILATION),
                                          jnp.asarray(vl))
    got = treg.get_op("sldwin_atten_mask_like").fn(
        w=BAND["w"], symmetric=symmetric)(torch.tensor(s),
                                          torch.tensor(DILATION),
                                          torch.tensor(vl))
    assert got.dtype == torch.float32
    onp.testing.assert_array_equal(_np(got), onp.asarray(want))


def test_sldwin_chunked_gather_equals_one_chunk(monkeypatch):
    """A band gathered a few rows at a time gives one chunk's values and
    gradients bitwise (each target row adds its terms in the same order)."""
    (q, k, v), scores, grads = _band_inputs(seed=1)
    runs = []
    for limit in (gio._CHUNK_BYTES, 1):
        monkeypatch.setattr(gio, "_CHUNK_BYTES", limit)
        got = []
        for name, a, b, g in (("sldwin_atten_score", q, k, grads[True][0]),
                              ("sldwin_atten_context", scores[True], v,
                               grads[True][1])):
            out, ta, tb = _port_band(name, True, a, b)
            out.backward(torch.tensor(g))
            got += [_np(out), _np(ta.grad), _np(tb.grad)]
        runs.append(got)
    assert len(gio._chunks(2, 24, 3, 9, 8, 4)) == 24
    for a, b in zip(*runs):
        onp.testing.assert_array_equal(a, b)


# -- the DGL ops -----------------------------------------------------------------
def _graph(n=30, seed=0, most=6):
    """A seeded CSR: every vertex 0-``most`` distinct neighbours."""
    rs = onp.random.RandomState(seed)
    rows = [onp.sort(rs.choice(n, rs.randint(0, most + 1), replace=False))
            for _ in range(n)]
    indptr = onp.concatenate([[0], onp.cumsum([len(r) for r in rows])])
    return indptr.astype("int64"), onp.concatenate(rows).astype("int64")


def _both(name, attrs, *arrays, device="cpu"):
    """(reference outputs, port outputs) as tuples of numpy arrays."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    want = jreg.get_op(name).fn(**attrs)(*(jnp.asarray(a) for a in arrays))
    got = treg.get_op(name).fn(**attrs)(
        *(torch.tensor(a, device=device) for a in arrays))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [onp.asarray(w) for w in want], [_np(g) for g in got]


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape, (w.dtype, g.dtype)
        onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,attrs,extra", [
    ("dgl_adjacency", {}, ()),
    ("dgl_subgraph", {}, ([3, 7, 0, 12, 7, 29],)),
    ("dgl_subgraph", {"return_mapping": True}, ([5, 1, 2, 9, 17],)),
    ("dgl_graph_compact", {}, ([4, 8, 15, 16, 23, -1, -1],)),
    ("edge_id", {}, ([0, 3, 5, 29, 11], [1, 7, 2, 0, 11])),
])
def test_deterministic_graph_ops_are_the_reference_bitwise(name, attrs,
                                                           extra):
    indptr, indices = _graph()
    arrays = [indptr, indices] + [onp.asarray(e, "int64") for e in extra]
    _same(*_both(name, attrs, *arrays))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_getnnz_is_the_reference(axis):
    x = onp.random.RandomState(2).randn(5, 7).astype("float32")
    x[x < 0.3] = 0
    _same(*_both("getnnz", {"axis": axis}, x))


def _check_sample(verts, offs, seeds, indptr, indices, num_neighbor, most,
                  prob=None):
    offs = [int(o) for o in offs]
    n = offs[-1]
    assert verts.dtype == onp.int32 and offs[0] == 0 and \
        offs == sorted(offs) and len(verts) == most
    assert list(verts[:len(seeds)]) == list(dict.fromkeys(seeds))
    assert (verts[n:] == -1).all() and len(set(verts[:n])) == n
    for hop in range(1, len(offs) - 1):
        prev = set(verts[offs[hop - 1]:offs[hop]].tolist())
        layer = verts[offs[hop]:offs[hop + 1]]
        assert len(layer) <= num_neighbor * len(prev)
        for u in layer:
            assert any(u in indices[indptr[p]:indptr[p + 1]] for p in prev)
            if prob is not None:
                assert prob[u] > 0


@pytest.mark.parametrize("uniform", [True, False])
def test_neighbour_samplers_keep_the_reference_structure(uniform):
    indptr, indices = _graph(n=60, seed=3)
    seeds = onp.array([0, 5, 5, 9], "int64")
    prob = onp.random.RandomState(4).rand(60).astype("float32")
    prob[prob < 0.3] = 0
    name = "dgl_csr_neighbor_uniform_sample" if uniform else \
        "dgl_csr_neighbor_non_uniform_sample"
    attrs = dict(num_hops=2, num_neighbor=3, max_num_vertices=40)
    args = [indptr, indices] + ([] if uniform else [prob]) + [seeds]
    fn = treg.get_op(name).fn(**attrs)
    samples = []
    for _ in range(2):
        tmx.random.seed(7)
        samples.append([_np(o) for o in fn(*map(torch.tensor, args))])
    _same(*samples)
    _check_sample(*samples[0], [0, 5, 9], indptr, indices, 3, 40,
                  None if uniform else prob)
    # the reference's sample has the same structure
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    ref = jreg.get_op(name).fn(**attrs)(jax.random.PRNGKey(0),
                                        *map(jnp.asarray, args))
    _check_sample(*(onp.asarray(r) for r in ref), [0, 5, 9], indptr,
                  indices, 3, 40, None if uniform else prob)


# -- the image and cv ops --------------------------------------------------------
def _image(h=30, w=40, seed=0):
    return onp.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype("uint8")


@pytest.mark.parametrize("name,attrs,dtype", [
    ("image_to_tensor", {}, "uint8"),
    ("image_normalize", {"mean": (0.485, 0.456, 0.406),
                         "std": (0.229, 0.224, 0.225)}, "chw"),
    ("image_normalize", {"mean": 0.5, "std": 0.25}, "chw"),
    ("image_resize", {"size": (20, 12)}, "uint8"),
    ("image_resize", {"size": 16, "keep_ratio": True}, "uint8"),
    ("image_crop", {"x": 3, "y": 5, "width": 11, "height": 7}, "uint8"),
    ("image_random_crop", {"size": (12, 9)}, "uint8"),
    ("image_random_resized_crop", {"size": 10}, "uint8"),
    ("cvimresize", {"w": 13, "h": 17}, "uint8"),
    ("cvcopyMakeBorder", {"top": 1, "bot": 2, "left": 3, "right": 4,
                          "value": 9.0}, "uint8"),
])
def test_image_ops_are_the_reference_bitwise(name, attrs, dtype):
    import mxnet_tpu as jmx

    x = _image()
    if dtype == "chw":
        x = (x.transpose(2, 0, 1) / 255.0).astype("float32")
    jmx.random.seed(3)
    tmx.random.seed(3)
    _same(*_both(name, attrs, x))


def test_cv_decode_and_read_are_the_reference_bitwise(tmp_path):
    from mxnet_tpu.ops import registry as jreg
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_image()).save(buf, format="PNG")
    path = tmp_path / "a.png"
    path.write_bytes(buf.getvalue())
    raw = onp.frombuffer(buf.getvalue(), "uint8")
    _same(*_both("cvimdecode", {}, raw))
    want = jreg.get_op("cvimread").fn(filename=str(path))()
    got = treg.get_op("cvimread").fn(filename=str(path))()
    assert got.device.type == "cpu"
    _same([onp.asarray(want)], [_np(got)])
    onp.testing.assert_array_equal(_np(got), _image())


def test_names_and_aliases_are_one_op():
    from mxnet_tpu.ops import registry as jreg

    names = [n for n in jreg.list_ops()
             if jreg.get_op(n)._make_fn.__module__ ==
             "mxnet_tpu.ops.graph_image_ops"]
    assert len(names) == 40
    for n in names:
        assert treg.get_op(n) is treg.get_op(jreg.get_op(n).name), n
        assert treg.get_op(n)._make_fn.__module__ == gio.__name__


def test_eager_ops_raise_in_a_hybridized_block_where_device_ops_run():
    from mxnet_tpu_torch import np as tnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import HybridBlock

    class ToTensor(HybridBlock):
        def forward(self, x):
            return npx.image_normalize(npx.image_to_tensor(x), mean=0.5,
                                       std=0.2)

    class Resize(HybridBlock):
        def forward(self, x):
            return npx.image_resize(x, size=(8, 8))

    x = tnp.array(_image())
    want = ToTensor()(x).asnumpy()
    net = ToTensor()
    net.hybridize()
    for _ in range(2):
        onp.testing.assert_array_equal(net(x).asnumpy(), want)
    net = Resize()
    net.hybridize()
    with pytest.raises(MXNetError, match="image_resize"):
        net(x)


# -- on the card -------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
def test_sldwin_on_the_card_matches_the_cpu(cuda, symmetric):
    (q, k, v), scores, grads = _band_inputs()
    for name, a, b, g in (("sldwin_atten_score", q, k, grads[symmetric][0]),
                          ("sldwin_atten_context", scores[symmetric], v,
                           grads[symmetric][1])):
        runs = []
        for dev in ("cpu", cuda):
            out, ta, tb = _port_band(name, symmetric, a, b, device=dev)
            out.backward(torch.tensor(g, device=dev))
            runs.append([_np(out), _np(ta.grad), _np(tb.grad)])
        for got, want in zip(*reversed(runs)):
            assert _rel(got, want) <= RTOL, name


@pytest.mark.cuda
def test_graph_and_image_ops_on_the_card_match_the_cpu(cuda):
    indptr, indices = _graph()
    cases = [("dgl_adjacency", {}, [indptr, indices]),
             ("dgl_subgraph", {"return_mapping": True},
              [indptr, indices, onp.array([3, 7, 0, 12])]),
             ("dgl_graph_compact", {}, [indptr, indices,
                                        onp.array([4, 8, 15, -1])]),
             ("edge_id", {}, [indptr, indices, onp.array([0, 3]),
                              onp.array([1, 7])]),
             ("dgl_csr_neighbor_uniform_sample",
              dict(num_hops=2, num_neighbor=2, max_num_vertices=20),
              [indptr, indices, onp.array([0, 5])]),
             ("getnnz", {"axis": 0}, [indices.reshape(-1, 1)]),
             ("image_to_tensor", {}, [_image()]),
             ("image_resize", {"size": (20, 12)}, [_image()]),
             ("image_random_crop", {"size": (12, 9)}, [_image()]),
             ("cvcopyMakeBorder", {"top": 1, "left": 2}, [_image()])]
    for name, attrs, arrays in cases:
        fn = treg.get_op(name).fn(**attrs)
        outs = []
        for dev in ("cpu", cuda):
            tmx.random.seed(5)
            got = fn(*(torch.tensor(a, device=dev) for a in arrays))
            got = got if isinstance(got, tuple) else (got,)
            assert all(t.device.type == torch.device(dev).type for t in got)
            outs.append([_np(t) for t in got])
        _same(*outs)
