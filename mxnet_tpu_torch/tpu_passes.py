"""Built-in "tpu" subgraph backend: pattern-match-and-replace passes.

Counterpart of ``mxnet_tpu/tpu_passes.py``; the backend keeps its name
because users' code passes it. The unit of replacement is a Symbol
subgraph, and on the card the replacement runs the hand-written Hopper
kernels.

Shipped pass: **attention fusion** — rewrites the hand-written attention
pattern

    logits = matmul(q, kᵀ)            (or einsum bhqd,bhkd->bhqk)
    logits = logits * s  |  logits / s  |  matmul(q * s, kᵀ)   [optional]
    logits = where(mask, logits, < -1e9)   [optional (B, 1, 1, Tk) mask]
    w      = softmax(logits, axis=-1)
    out    = matmul(w, v)             (or einsum bhqk,bhkd->bhqd)

into one ``flash_attention`` node: ``csrc/flash_fwd.cu`` forward and, under
``autograd.record()``, ``csrc/flash_bwd.cu`` and ``csrc/flash_bwd_dq.cu``,
with no T×T intermediate. A key-padding mask becomes segment ids (query
side all ones, key side ``mask != 0``) only when Tq = Tk = the mask's Tk.
Matched interior nodes must have no other consumers; the head node is
rewritten in place so downstream references survive.
"""
from __future__ import annotations

from .subgraph import register_backend, register_pass
from .symbol.symbol import Literal, Symbol, SymNode, topo_sort

register_backend("tpu")


def _consumer_counts(nodes, entries):
    counts: dict[int, int] = {}
    for n in nodes:
        for e in n.inputs:
            if not isinstance(e, Literal):
                counts[id(e[0])] = counts.get(id(e[0]), 0) + 1
    for node, _ in entries:
        counts[id(node)] = counts.get(id(node), 0) + 1
    return counts


def _op_name(node):
    return node.op.name if node.op is not None else None


def _scalar_of(entry):
    """Literal / 0-d const entry → python float, else None."""
    if isinstance(entry, Literal):
        v = entry.value
        return float(v) if isinstance(v, (int, float)) else None
    node, _ = entry
    if node.is_const and getattr(node.value, "ndim", None) == 0:
        return float(node.value)
    return None


def _is_kt(entry):
    """Does this entry transpose the last two axes of its input?
    Returns the un-transposed producer entry, or None."""
    if isinstance(entry, Literal):
        return None
    node, idx = entry
    name = _op_name(node)
    if name == "transpose":
        axes = node.attrs.get("axes")
        if axes is not None:
            axes = tuple(axes)
            n = len(axes)
            want = tuple(range(n - 2)) + (n - 1, n - 2)
            if axes == want:
                return node.inputs[0]
    elif name == "swapaxes":
        a1 = node.attrs.get("axis1", 0)
        a2 = node.attrs.get("axis2", 1)
        if {a1, a2} in ({-1, -2}, {2, 3}):
            return node.inputs[0]
    return None


def _match_qk(node):
    """Match a q·kᵀ logits node → (q_entry, k_entry, scale) or None."""
    name = _op_name(node)
    if name == "matmul":
        q_e, kt_e = node.inputs[0], node.inputs[1]
        k_e = _is_kt(kt_e)
        if k_e is None:
            return None
        scale = 1.0
        # scale folded onto q: matmul(multiply(q, s), kT)
        if not isinstance(q_e, Literal):
            qn, _ = q_e
            if _op_name(qn) == "multiply":
                s = _scalar_of(qn.inputs[1]) or _scalar_of(qn.inputs[0])
                if s is not None:
                    other = qn.inputs[0] if _scalar_of(qn.inputs[1]) \
                        is not None else qn.inputs[1]
                    return other, k_e, s
        return q_e, k_e, scale
    if name == "einsum":
        sub = node.attrs.get("subscripts", "").replace(" ", "")
        if sub == "bhqd,bhkd->bhqk":
            return node.inputs[0], node.inputs[1], 1.0
    return None


def _entry_shape(entry):
    """Static shape of a graph entry when known: const value shape, or a
    var's recorded ``shape=`` from ``sym.var`` — else None."""
    if isinstance(entry, Literal):
        return None
    node, _ = entry
    if node.is_const:
        return tuple(node.value.shape)
    ann = node.attr_dict.get("__shape__")
    if ann:
        try:
            return tuple(int(x) for x in ann.strip("()").split(",") if x)
        except ValueError:
            return None
    return None


def _match_key_padding_mask(node, counts):
    """Match ``where(mask, logits, big_negative)`` where mask is statically
    known to be a (B, 1, 1, Tk) key-padding mask. Returns
    (logits_node, mask_entry) or None."""
    if _op_name(node) not in ("where", "_npi_where") or \
            counts.get(id(node), 0) != 1:
        return None
    cond_e, x_e, y_e = node.inputs
    neg = _scalar_of(y_e)
    if neg is None or neg > -1e9 or isinstance(x_e, Literal):
        return None
    shape = _entry_shape(cond_e)
    if shape is None or len(shape) != 4 or shape[1] != 1 or shape[2] != 1:
        return None
    return x_e[0], cond_e, shape


def _match_attention(out_node, counts):
    """Match out_node = matmul(softmax([mask](scale(q·kᵀ))), v). Returns
    (q_entry, k_entry, v_entry, scale, mask_entry_or_None, mask_shape)
    or None."""
    name = _op_name(out_node)
    if name == "matmul":
        w_e, v_e = out_node.inputs[0], out_node.inputs[1]
    elif name == "einsum" and out_node.attrs.get(
            "subscripts", "").replace(" ", "") == "bhqk,bhkd->bhqd":
        w_e, v_e = out_node.inputs[0], out_node.inputs[1]
    else:
        return None
    if isinstance(w_e, Literal):
        return None
    w, _ = w_e
    if _op_name(w) != "softmax" or counts.get(id(w), 0) != 1:
        return None
    if w.attrs.get("axis", -1) not in (-1, 3):
        return None
    if w.attrs.get("use_length") or w.attrs.get("temperature") not in (
            None, 1.0):
        return None
    s_e = w.inputs[0]
    if isinstance(s_e, Literal):
        return None
    s_node, _ = s_e
    # optional key-padding mask: softmax(where(mask, logits, -big))
    mask_e = mask_shape = None
    masked = _match_key_padding_mask(s_node, counts)
    if masked is not None:
        s_node, mask_e, mask_shape = masked
    scale_mult = 1.0
    logits = s_node
    # optional explicit scaling of the logits
    if _op_name(s_node) in ("multiply", "true_divide") and \
            counts.get(id(s_node), 0) == 1:
        sc = _scalar_of(s_node.inputs[1])
        if sc is None and _op_name(s_node) == "multiply":
            sc = _scalar_of(s_node.inputs[0])
            cand = s_node.inputs[1]
        else:
            cand = s_node.inputs[0]
        if sc is not None and not isinstance(cand, Literal):
            scale_mult = (1.0 / sc if _op_name(s_node) == "true_divide"
                          else sc)
            logits = cand[0]
    if counts.get(id(logits), 0) != 1:
        return None
    qk = _match_qk(logits)
    if qk is None:
        return None
    q_e, k_e, q_scale = qk
    return q_e, k_e, v_e, scale_mult * q_scale, mask_e, mask_shape


@register_pass("tpu")
def fuse_attention(sym: Symbol) -> Symbol:
    """Rewrite eligible attention subgraphs onto ``flash_attention`` —
    including the key-padding-masked form, whose (B, 1, 1, Tk) mask is
    lowered to segment ids (query side all-valid, key side the mask) so
    padded batches stay on the fused kernel."""
    from .ops.registry import get_op

    nodes = topo_sort(sym._entries)
    counts = _consumer_counts(nodes, sym._entries)
    flash = get_op("flash_attention")
    for node in nodes:
        m = _match_attention(node, counts)
        if m is None:
            continue
        q_e, k_e, v_e, scale, mask_e, mask_shape = m
        inputs = (q_e, k_e, v_e)
        if mask_e is not None:
            b, _, _, tk = mask_shape
            # only rewrite when q/k shapes are statically known to be
            # compatible: self-attention (Tq == Tk == mask Tk, same batch).
            # Cross-attention padding masks (Tq != Tk) would build segment
            # ids of the wrong length — leave those graphs alone
            q_shape, k_shape = _entry_shape(q_e), _entry_shape(k_e)
            if (q_shape is None or k_shape is None or len(q_shape) < 2 or
                    q_shape[-2] != tk or k_shape[-2] != tk or
                    q_shape[0] != b):
                continue
            # normalize truthiness to 0/1 ids the way where() would
            # (any nonzero mask value means "keep")
            flat = SymNode(op=get_op("reshape"),
                           attrs={"newshape": (b, tk)}, inputs=(mask_e,))
            k_seg = SymNode(op=get_op("not_equal"),
                            inputs=((flat, 0), Literal(0)))
            q_seg = SymNode(op=get_op("ones_like"), inputs=((k_seg, 0),))
            inputs = (q_e, k_e, v_e, (q_seg, 0), (k_seg, 0))
        # rewrite the head node in place: downstream (SymNode, idx)
        # references — including graph outputs — stay valid
        node.op = flash
        node.attrs = {"scale": scale, "causal": False}
        node.inputs = inputs
    return sym
