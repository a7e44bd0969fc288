"""Network visualization: ``print_summary`` (a table of a block's
parameters or of a Symbol's nodes) and ``plot_network`` (a graphviz dot
description of a Symbol). Counterpart of ``mxnet_tpu/visualization.py``."""
from __future__ import annotations

import numpy as onp

from .base import MXNetError
from .symbol.symbol import Symbol, topo_sort

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol_or_block, shape=None, line_length=92):
    """Print a per-node summary table (reference: print_summary)."""
    from .gluon.block import Block

    lines = []
    if isinstance(symbol_or_block, Block):
        params = symbol_or_block.collect_params()
        header = f"{'Parameter':<48}{'Shape':<24}{'#':>12}"
        lines.append("=" * line_length)
        lines.append(header)
        lines.append("=" * line_length)
        total = 0
        for name, p in params.items():
            n = int(onp.prod(tuple(p.shape))) if p.dim() and all(
                s > 0 for s in p.shape) else 0
            total += n
            lines.append(f"{name:<48}{str(tuple(p.shape)):<24}{n:>12}")
        lines.append("=" * line_length)
        lines.append(f"Total params: {total}")
    elif isinstance(symbol_or_block, Symbol):
        lines.append("=" * line_length)
        lines.append(f"{'Node':<12}{'Op':<28}{'Inputs'}")
        lines.append("=" * line_length)
        nodes = topo_sort(symbol_or_block._entries)
        idx = {id(n): i for i, n in enumerate(nodes)}
        for n in nodes:
            if n.is_var:
                op = "Variable"
                ins = n.name or ""
            elif n.is_const:
                op = "Const"
                ins = str(tuple(n.value.shape))
            else:
                op = n.op.name
                ins = ",".join(str(idx[id(e[0])]) for e in n.inputs
                               if not hasattr(e, "value"))
            lines.append(f"{idx[id(n)]:<12}{op:<28}{ins}")
        lines.append("=" * line_length)
    else:
        raise MXNetError("print_summary expects a Symbol or Block")
    out = "\n".join(lines)
    print(out)
    return out


def plot_network(symbol, title="plot", save_format="dot", shape=None,
                 **kwargs):
    """Emit a graphviz dot description (graphviz rendering optional)."""
    if not isinstance(symbol, Symbol):
        raise MXNetError("plot_network expects a Symbol")
    nodes = topo_sort(symbol._entries)
    idx = {id(n): i for i, n in enumerate(nodes)}
    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    for n in nodes:
        label = n.name if n.is_var else ("const" if n.is_const
                                         else n.op.name)
        shape_attr = "ellipse" if n.is_var else "box"
        lines.append(f'  n{idx[id(n)]} [label="{label}", '
                     f"shape={shape_attr}];")
        for e in n.inputs:
            if not hasattr(e, "value"):
                lines.append(f"  n{idx[id(e[0])]} -> n{idx[id(n)]};")
    lines.append("}")
    return "\n".join(lines)
