"""Sliding-window attention, the DGL graph ops, and the image and cv ops.

Counterpart of ``mxnet_tpu/ops/graph_image_ops.py``, its 40 names:

- ``sldwin_atten_score``/``_context``/``_mask_like``
  (src/operator/contrib/transformer.cc): banded (Longformer-style)
  attention over (B, L, H, D) operands. Key ``k`` of query ``l`` in head
  ``h`` is position ``l + offset_k * dilation[h]``, the offsets ``-w..w``
  (symmetric) or ``-w..0`` (causal), and the per-head dilation is a tensor
  operand; entries outside the sequence are exact zeros. The reference
  gathers the whole band, (B, H, L, W, D), at once: 6.4 GB in fp32 at
  Longformer-base's (1, 4096, 12, 64) and w = 256. Here the band is
  gathered a chunk of rows at a time (:data:`_CHUNK_BYTES` a chunk), in
  forward and in backward alike: ``score`` and ``context`` are
  ``torch.autograd.Function``s whose backward gathers again, and the
  scatter of the key and value gradients is an ``index_add_``. The values
  are the reference's gather-then-reduce, summed in another order.
- ``dgl_*``, ``edge_id`` (src/operator/contrib/dgl_graph.cc): graph ops over
  CSR operands (indptr, indices), eager host ops as the reference's (it
  registers them ``jit=False``; its C++ runs them on the CPU only): the
  operands are read to the host, the results land on the operands'
  device, and inside a compiled program they raise. The neighbour
  samplers draw from a ``RandomState`` seeded by one draw of the port's
  CPU generator (``mx.random.generator("cpu")``), so one
  ``mx.random.seed(n)`` gives one sample whichever device holds the
  graph; the reference seeds from its JAX key, which the port cannot
  reproduce. ``getnnz`` is a device op.
- ``image_to_tensor`` and ``image_normalize`` are device ops, which capture
  in a hybridized block; ``image_resize``/``_crop``/``_random_crop``/
  ``_random_resized_crop`` and ``cvimresize``/``cvcopyMakeBorder``/
  ``cvimdecode``/``cvimread`` bridge onto ``mx.image``'s host pipeline
  (imported lazily), eager as the reference's, their results on the
  operand's device.
"""
from __future__ import annotations

import numpy as onp
import torch

from .registry import register, register_alias

# ---------------------------------------------------------------------------
# sliding-window attention (reference :31-92)
# ---------------------------------------------------------------------------
_CHUNK_BYTES = 1 << 28      # the gathered band of one chunk of rows, at most


def _band(lo, hi, L, dilation, w, symmetric):
    """``idx[h, l, k] = l + offset_k * dilation[h]`` for rows ``lo:hi``,
    clipped to ``[0, L)``, and whether the unclipped index lies there."""
    dev = dilation.device
    offs = torch.arange(-w, w + 1 if symmetric else 1, device=dev)
    d = dilation.to(torch.int64).reshape(-1, 1, 1)
    pos = torch.arange(lo, hi, device=dev).reshape(1, -1, 1)
    raw = pos + offs.reshape(1, 1, -1) * d                  # (H, c, W)
    valid = (raw >= 0) & (raw < L)
    return raw.clamp(0, L - 1), valid


def _chunks(B, L, H, W, D, elt):
    rows = max(1, min(L, _CHUNK_BYTES // max(1, B * H * W * D * elt)))
    return [(lo, min(L, lo + rows)) for lo in range(0, L, rows)]


def _gather(src_t, idx):
    """``src_t[b, h, idx[h, l, k], :]``: (B, H, c, W, D) of (B, H, L, D)."""
    heads = torch.arange(src_t.shape[1], device=src_t.device)
    return src_t[:, heads.reshape(-1, 1, 1), idx, :]


def _band_dot(a, src, dilation, w, symmetric):
    """``out[b, l, h, k] = <a[b, l, h], src[b, idx[h, l, k], h]>``, zero
    outside the sequence: (B, L, H, W)."""
    B, L, H, D = a.shape
    W = 2 * w + 1 if symmetric else w + 1
    a_t, s_t = a.transpose(1, 2), src.transpose(1, 2)       # (B, H, L, D)
    out = a.new_empty((B, H, L, W))
    for lo, hi in _chunks(B, L, H, W, D, a.element_size()):
        idx, valid = _band(lo, hi, L, dilation, w, symmetric)
        band = _gather(s_t, idx)                            # (B, H, c, W, D)
        dots = (band @ a_t[:, :, lo:hi, :, None])[..., 0]   # (B, H, c, W)
        out[:, :, lo:hi] = torch.where(valid, dots, 0.0)
    return out.transpose(1, 2)


def _band_mix(s, src, dilation, w, symmetric):
    """``out[b, l, h] = sum_k s[b, l, h, k] src[b, idx[h, l, k], h]``, the
    terms outside the sequence left out: (B, L, H, D)."""
    B, L, H, W = s.shape
    D = src.shape[-1]
    s_t, v_t = s.transpose(1, 2), src.transpose(1, 2)
    out = src.new_empty((B, H, L, D))
    for lo, hi in _chunks(B, L, H, W, D, src.element_size()):
        idx, valid = _band(lo, hi, L, dilation, w, symmetric)
        band = _gather(v_t, idx)                            # (B, H, c, W, D)
        sc = torch.where(valid, s_t[:, :, lo:hi], 0.0)      # (B, H, c, W)
        out[:, :, lo:hi] = (sc[..., None, :] @ band)[..., 0, :]
    return out.transpose(1, 2)


def _band_scatter(s, a, dilation, w, symmetric):
    """``out[b, idx[h, l, k], h] += s[b, l, h, k] a[b, l, h]`` over the
    entries inside the sequence: (B, L, H, D)."""
    B, L, H, W = s.shape
    D = a.shape[-1]
    s_t, a_t = s.transpose(1, 2), a.transpose(1, 2)
    out = a.new_zeros((B, H * L, D))
    heads = torch.arange(H, device=a.device).reshape(-1, 1, 1) * L
    for lo, hi in _chunks(B, L, H, W, D, a.element_size()):
        idx, valid = _band(lo, hi, L, dilation, w, symmetric)
        sc = torch.where(valid, s_t[:, :, lo:hi], 0.0)      # (B, H, c, W)
        terms = sc[..., None] * a_t[:, :, lo:hi, None, :]   # (B, H, c, W, D)
        out.index_add_(1, (heads + idx).reshape(-1),
                       terms.reshape(B, -1, D))
    return out.reshape(B, H, L, D).transpose(1, 2)


class _Score(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, dilation, w, symmetric):
        ctx.save_for_backward(query, key, dilation)
        ctx.band = (w, symmetric)
        return _band_dot(query, key, dilation, w, symmetric)

    @staticmethod
    def backward(ctx, g):
        query, key, dilation = ctx.saved_tensors
        w, symmetric = ctx.band
        dq = _band_mix(g, key, dilation, w, symmetric) \
            if ctx.needs_input_grad[0] else None
        dk = _band_scatter(g, query, dilation, w, symmetric) \
            if ctx.needs_input_grad[1] else None
        return dq, dk, None, None, None


class _Context(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score, value, dilation, w, symmetric):
        ctx.save_for_backward(score, value, dilation)
        ctx.band = (w, symmetric)
        return _band_mix(score, value, dilation, w, symmetric)

    @staticmethod
    def backward(ctx, g):
        score, value, dilation = ctx.saved_tensors
        w, symmetric = ctx.band
        ds = _band_dot(g, value, dilation, w, symmetric) \
            if ctx.needs_input_grad[0] else None
        dv = _band_scatter(score, g, dilation, w, symmetric) \
            if ctx.needs_input_grad[1] else None
        return ds, dv, None, None, None


@register("sldwin_atten_score")
def _sldwin_score(w=1, symmetric=True, **a):
    """(B, L, H, W) scores of ``query`` against the band of ``key``."""
    return lambda query, key, dilation: _Score.apply(
        query, key, dilation, int(w), bool(symmetric))


@register("sldwin_atten_context")
def _sldwin_context(w=1, symmetric=True, **a):
    """(B, L, H, D) band-weighted sums of ``value`` by ``score``."""
    return lambda score, value, dilation: _Context.apply(
        score, value, dilation, int(w), bool(symmetric))


@register("sldwin_atten_mask_like")
def _sldwin_mask_like(w=1, symmetric=True, **a):
    """1 where the band entry and its query both lie inside the row's
    valid length, else 0, in ``score``'s shape and dtype."""
    def f(score, dilation, val_length):
        B, L, H, W = score.shape
        idx, valid = _band(0, L, L, dilation, w, symmetric)  # (H, L, W)
        vl = val_length.to(torch.int64).reshape(B, 1, 1, 1)
        pos = torch.arange(L, device=score.device).reshape(1, 1, L, 1)
        mask = valid[None] & (idx[None] < vl) & (pos < vl)  # (B, H, L, W)
        return mask.transpose(1, 2).to(score.dtype)

    return f


for _n in ("score", "context", "mask_like"):
    register_alias(f"_contrib_sldwin_atten_{_n}", f"sldwin_atten_{_n}")


# ---------------------------------------------------------------------------
# DGL graph ops (reference :98-271): eager, on the host
# ---------------------------------------------------------------------------
def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else onp.asarray(t)


def _back(a, like):
    """Host array ``a`` as an int32 tensor on ``like``'s device."""
    return torch.from_numpy(onp.ascontiguousarray(a, dtype="int32")).to(
        like.device)


def _induced(ip, ix, vs):
    """CSR (indptr, indices, edge ids) of the subgraph induced by vertex
    list ``vs``, relabelled to its positions (a repeated vertex takes its
    last position), rows in ``vs``'s order."""
    relabel = onp.full(ip.shape[0] - 1, -1, "int64")
    if len(vs):
        # the last position of each vertex, as a dict built in order keeps
        rev_first = onp.unique(vs[::-1], return_index=True)
        relabel[rev_first[0]] = len(vs) - 1 - rev_first[1]
    starts, counts = ip[vs], ip[vs + 1] - ip[vs]
    total = int(counts.sum())
    row = onp.repeat(onp.arange(len(vs)), counts)
    first = onp.concatenate([[0], onp.cumsum(counts)[:-1]]).astype("int64") \
        if len(vs) else onp.zeros(0, "int64")
    eids = onp.arange(total) - onp.repeat(first, counts) + \
        onp.repeat(starts, counts)
    new = relabel[ix[eids]] if total else onp.zeros(0, "int64")
    keep = new >= 0
    indptr = onp.concatenate(
        [[0], onp.cumsum(onp.bincount(row[keep], minlength=len(vs)))])
    return indptr, new[keep], eids[keep]


@register("dgl_adjacency", differentiable=False, eager_only=True)
def _dgl_adjacency(**a):
    """The graph's (N, N) adjacency, 1 at each edge: dense, as the
    reference's."""
    def f(indptr, indices):
        ip, ix = _host(indptr).astype("int64"), _host(indices)
        n = ip.shape[0] - 1
        out = onp.zeros((n, n), dtype="float32")
        out[onp.repeat(onp.arange(n), onp.diff(ip)), ix[ip[0]:ip[-1]]] = 1.0
        return torch.from_numpy(out).to(indptr.device)

    return f


@register("dgl_subgraph", nout=2, differentiable=False, eager_only=True)
def _dgl_subgraph(return_mapping=False, **a):
    """Vertex-induced subgraph: (sub_indptr, sub_indices[, edge ids])."""
    def f(indptr, indices, vids):
        ip, ix = _host(indptr).astype("int64"), _host(indices)
        vs = _host(vids).astype("int32").astype("int64")
        new_ip, new_ix, eids = _induced(ip, ix, vs)
        outs = (_back(new_ip, indptr), _back(new_ix, indptr))
        return outs + (_back(eids, indptr),) if return_mapping else outs

    return f


def _sample_seed():
    """One draw of the port's CPU generator: the seed of a sampler's
    ``RandomState``, the same after one ``mx.random.seed`` whichever device
    holds the graph."""
    from .. import random as _random

    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=_random.generator("cpu")))


def _neighbour_sample(ip, ix, seeds, num_hops, num_neighbor,
                      max_num_vertices, prob=None):
    """The reference's hop loop (:143-228): each frontier vertex draws up to
    ``num_neighbor`` neighbours without replacement (by ``prob`` where
    given); returns the vertices padded with -1 and the hop offsets."""
    rng = onp.random.RandomState(_sample_seed())
    frontier = list(dict.fromkeys(int(s) for s in seeds))
    seen = list(frontier)
    seen_set = set(seen)
    offsets = [0, len(frontier)]
    for _ in range(num_hops):
        nxt = []
        for v in frontier:
            nbrs = ix[ip[v]:ip[v + 1]]
            if len(nbrs) == 0:
                continue
            if prob is None:
                take = rng.choice(nbrs, size=min(num_neighbor, len(nbrs)),
                                  replace=False)
            else:
                p = prob[nbrs]
                total = p.sum()
                if total <= 0:
                    continue  # no reachable neighbour under this measure
                p = p / total
                take = rng.choice(
                    nbrs, size=min(num_neighbor, int((p > 0).sum())),
                    replace=False, p=p)
            nxt.extend(int(u) for u in take)
        nxt = [u for u in dict.fromkeys(nxt) if u not in seen_set]
        seen.extend(nxt)
        seen_set.update(nxt)
        frontier = nxt
        offsets.append(len(seen))
    out = onp.full(max_num_vertices, -1, "int32")
    out[:len(seen)] = seen[:max_num_vertices]
    return out, onp.asarray(offsets, "int32")


@register("dgl_csr_neighbor_uniform_sample", nout=2, differentiable=False,
          eager_only=True)
def _dgl_neighbor_uniform(num_hops=1, num_neighbor=2, max_num_vertices=100,
                          **a):
    """Uniform neighbour sampling from ``seeds``: (vertices padded to
    ``max_num_vertices`` with -1, hop offsets)."""
    def f(indptr, indices, seeds):
        out, offs = _neighbour_sample(
            _host(indptr), _host(indices), _host(seeds), num_hops,
            num_neighbor, max_num_vertices)
        return _back(out, indptr), _back(offs, indptr)

    return f


@register("dgl_csr_neighbor_non_uniform_sample", nout=2,
          differentiable=False, eager_only=True)
def _dgl_neighbor_non_uniform(num_hops=1, num_neighbor=2,
                              max_num_vertices=100, **a):
    """Neighbour sampling weighted by the per-vertex ``probability``."""
    def f(indptr, indices, probability, seeds):
        out, offs = _neighbour_sample(
            _host(indptr), _host(indices), _host(seeds), num_hops,
            num_neighbor, max_num_vertices,
            prob=_host(probability).astype("float64"))
        return _back(out, indptr), _back(offs, indptr)

    return f


@register("dgl_graph_compact", nout=2, differentiable=False, eager_only=True)
def _dgl_graph_compact(return_mapping=False, graph_sizes=(), **a):
    """The subgraph of the vertex ids that are not padding (-1),
    relabelled to ``[0, n)``."""
    def f(indptr, indices, vids):
        ip, ix = _host(indptr).astype("int64"), _host(indices)
        vs = _host(vids).astype("int64")
        new_ip, new_ix, _ = _induced(ip, ix, vs[vs >= 0])
        return _back(new_ip, indptr), _back(new_ix, indptr)

    return f


@register("edge_id", differentiable=False, eager_only=True)
def _edge_id(**a):
    """``edge_id(indptr, indices, u, v)``: the position of edge (u, v) in
    ``indices``, -1 where there is none."""
    def f(indptr, indices, u, v):
        ip, ix = _host(indptr), _host(indices)
        us, vs = _host(u).ravel(), _host(v).ravel()
        out = onp.full(us.shape, -1, "int32")
        for i, (a_, b_) in enumerate(zip(us.tolist(), vs.tolist())):
            a_, b_ = int(a_), int(b_)
            hit = onp.flatnonzero(ix[ip[a_]:ip[a_ + 1]] == b_)
            if hit.size:
                out[i] = int(ip[a_]) + int(hit[0])
        return _back(out, indptr)

    return f


register_alias("_contrib_dgl_adjacency", "dgl_adjacency")
register_alias("_contrib_dgl_subgraph", "dgl_subgraph")
register_alias("_contrib_dgl_csr_neighbor_uniform_sample",
               "dgl_csr_neighbor_uniform_sample")
register_alias("_contrib_dgl_csr_neighbor_non_uniform_sample",
               "dgl_csr_neighbor_non_uniform_sample")
register_alias("_contrib_dgl_graph_compact", "dgl_graph_compact")
register_alias("_contrib_edge_id", "edge_id")

register("getnnz", lambda axis=None, **a:
         (lambda x: torch.count_nonzero(x, dim=axis).to(torch.int32)),
         differentiable=False)
register_alias("_contrib_getnnz", "getnnz")


# ---------------------------------------------------------------------------
# image and cv ops (reference :284-414)
# ---------------------------------------------------------------------------
def _img_mod():
    from .. import image as img

    return img


def _channels(vals, like):
    """A (C, 1, 1) tensor of ``vals`` in ``like``'s dtype and device, made
    by fills (no host copy, so it captures)."""
    vals = onp.asarray(vals, dtype="float64").reshape(-1)
    out = like.new_empty((len(vals),))
    for i, v in enumerate(vals.tolist()):
        out[i].fill_(v)
    return out.reshape(-1, 1, 1)


# the reference's jitted ``x / 255.0`` is XLA's product with the float32
# reciprocal
_INV_255 = float(onp.float32(1.0) / onp.float32(255.0))

register("image_to_tensor", lambda **a:
         (lambda x: (x.to(torch.float32) * _INV_255).permute(
             (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2))))
register_alias("_image_to_tensor", "image_to_tensor")

def _image_normalize(mean=0.0, std=1.0, **a):
    """``(x - mean) / std`` per channel, the division as the reference's
    XLA program does it: a product with each ``std``'s float32
    reciprocal."""
    inv = (onp.float32(1.0) / onp.asarray(std, "float32")).tolist()
    return lambda x: (x - _channels(mean, x)) * _channels(inv, x)


register("image_normalize", _image_normalize)
register_alias("_image_normalize", "image_normalize")


def _bridge(fn):
    """An op function of one image tensor that runs ``fn`` on its host
    array and puts the result back on the tensor's device."""
    def f(x):
        out = fn(_host(x))
        return out._data.to(x.device)

    return f


@register("image_resize", differentiable=False, eager_only=True)
def _image_resize(size=(), keep_ratio=False, interp=1, **a):
    def run(x):
        img = _img_mod()
        if keep_ratio and isinstance(size, int):
            # an int size with keep_ratio resizes the shorter edge
            return img.resize_short(x, size, interp=interp)
        w, h = (size, size) if isinstance(size, int) else \
            (size[0], size[1])
        return img.imresize(x, w, h, interp=interp)

    return _bridge(run)


register_alias("_image_resize", "image_resize")


@register("image_crop", differentiable=False, eager_only=True)
def _image_crop(x=0, y=0, width=0, height=0, **a):
    return lambda data: data[y:y + height, x:x + width]


register_alias("_image_crop", "image_crop")


@register("image_random_crop", differentiable=False, eager_only=True)
def _image_random_crop(size=(), interp=1, **a):
    # the draws come from mx.random.host_rng, as the host augmenters'
    crop = size if not isinstance(size, int) else (size, size)
    return _bridge(lambda x: _img_mod().random_crop(x, crop,
                                                    interp=interp)[0])


register_alias("_image_random_crop", "image_random_crop")


@register("image_random_resized_crop", differentiable=False,
          eager_only=True)
def _image_random_resized_crop(size=(), scale=(0.08, 1.0),
                               ratio=(0.75, 1.333), interp=1, **a):
    crop = size if not isinstance(size, int) else (size, size)
    return _bridge(lambda x: _img_mod().RandomSizedCropAug(
        crop, scale, ratio, interp)(x))


register_alias("_image_random_resized_crop", "image_random_resized_crop")


@register("cvimresize", differentiable=False, eager_only=True)
def _cvimresize(w=0, h=0, interp=1, **a):
    return _bridge(lambda x: _img_mod().imresize(x, w, h, interp=interp))


register_alias("_cvimresize", "cvimresize")


@register("cvcopyMakeBorder", differentiable=False, eager_only=True)
def _cv_copy_make_border(top=0, bot=0, left=0, right=0, type=0, value=0.0,
                         **a):
    """A constant border of ``value`` around an (H, W, ...) image (the
    reference pads with a constant whatever ``type`` says)."""
    def f(x):
        pad = (0, 0) * (x.dim() - 2) + (left, right, top, bot)
        return torch.nn.functional.pad(x, pad, value=value)

    return f


register_alias("_cvcopyMakeBorder", "cvcopyMakeBorder")


@register("cvimdecode", differentiable=False, eager_only=True)
def _cvimdecode(flag=1, to_rgb=True, **a):
    def f(buf):
        raw = _host(buf).astype("uint8").tobytes()
        img = _img_mod().imdecode(raw, flag=flag, to_rgb=to_rgb)
        return img._data.to(buf.device)

    return f


register_alias("_cvimdecode", "cvimdecode")


@register("cvimread", differentiable=False, eager_only=True)
def _cvimread(filename="", flag=1, to_rgb=True, **a):
    """The image file ``filename``, on ``ctx`` (the current context when
    None)."""
    def f():
        from ..context import resolve_device

        img = _img_mod().imread(filename, flag=flag, to_rgb=to_rgb)
        return img._data.to(resolve_device(a.get("ctx")))

    return f


register_alias("_cvimread", "cvimread")
