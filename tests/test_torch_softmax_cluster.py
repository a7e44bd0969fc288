"""PyTorch/CUDA port: the arithmetic of the fused softmax's wide-row path
(``mxnet_tpu_torch/csrc/softmax.cu``, ``softmax_wide_kernel``), modelled in
numpy.

The kernel cannot run on the CPU, so this file rebuilds what it computes: a
cluster of eight blocks owns one row, each block a contiguous slice of
ceil(d / 8) elements, which it loads once (a 16-byte-aligned body of
vectors, a scalar head and tail), reduces to a partial (m_r, s_r) in fp32
and combines with its peers' partials in the fixed order r = 0..7. The
model is held to the JAX package's ``fused_softmax``
(``mxnet_tpu/ops/pallas_kernels.py:978``, ``jax.nn.softmax`` on the CPU)
at GPT-2's vocabulary width and at widths whose slices split unevenly.
"""
import jax.numpy as jnp
import numpy as onp
import pytest

from mxnet_tpu.ops.pallas_kernels import fused_softmax

CLUSTER = 8          # softmax.cu kCluster
WIDE_MIN_D = 4096    # softmax.cu kWideMinD: the wide path's first width
SOFTMAX_TOL = 1e-6   # chip_smoke.py's limit for fp32


def slices(d, cluster=CLUSTER):
    """[lo, hi) of each block's slice of a d-wide row; the last ones may
    be short or empty."""
    n = -(-d // cluster)
    return [(min(r * n, d), min(r * n + n, d)) for r in range(cluster)]


def pieces(lo, hi, mis, vec):
    """The kernel's head, body and tail of slice [lo, hi) whose first
    element lies ``mis`` elements past a 16-byte boundary (``vec`` elements
    a vector): head [lo, a0), body vectors [a0, a1), tail [a1, hi), and
    ``base``, the aligned-down start that shared memory is indexed from."""
    a0 = min(lo + (vec - mis) % vec, hi)
    a1 = a0 + (hi - a0) // vec * vec
    return a0, a1, lo - mis


def partial(xs):
    """A block's partial (m_r, s_r) of its slice, in fp32: the maximum,
    then the sum of exp(x - m_r); (-inf, 0) for an empty slice."""
    if xs.size == 0:
        return onp.float32(-onp.inf), onp.float32(0)
    m = xs.max()
    return m, onp.exp(xs - m, dtype=onp.float32).sum(dtype=onp.float32)


def combine(parts):
    """The cluster's (m, s) from its partials, in the fixed order r = 0..7,
    as every block computes it."""
    m = parts[0][0]
    for mr, _ in parts[1:]:
        m = max(m, mr)
    s = onp.float32(0)
    for mr, sr in parts:
        s = onp.float32(s + sr * onp.exp(onp.float32(mr - m)))
    return m, s


def model_softmax_wide(x, cluster=CLUSTER):
    """(rows, d) fp32 softmax through the wide path: per row, each slice's
    partial, the fixed-order combine, then exp(x - m) / s per slice."""
    x = onp.asarray(x, onp.float32)
    out = onp.empty_like(x)
    for r in range(x.shape[0]):
        sl = slices(x.shape[1], cluster)
        m, s = combine([partial(x[r, lo:hi]) for lo, hi in sl])
        for lo, hi in sl:
            out[r, lo:hi] = onp.exp(x[r, lo:hi] - m) / s
    return out


def _reference(x):
    return onp.asarray(fused_softmax(jnp.asarray(x)))


@pytest.mark.parametrize("rows,d", [(64, 50257), (3, 4097), (5, 4103),
                                    (2, 8191), (1, 60001)])
def test_cluster_combine_matches_reference(rows, d):
    # 50257 / 8: seven slices of 6283 and one of 6276; 4097, 4103, 8191
    # and 60001 leave the last slice shorter by 1-7 elements
    x = (onp.random.RandomState(d).randn(rows, d) * 4).astype("float32")
    got = model_softmax_wide(x)
    want = _reference(x)
    assert float(onp.abs(got - want).max()) <= SOFTMAX_TOL
    # relative too: at vocabulary width a value is ~2e-5
    assert float((onp.abs(got - want) / want).max()) <= 1e-5


def test_cluster_combine_with_empty_slices_and_one_hot_row():
    # d = 9 over eight blocks: slices of 2, the fifth holds one element and
    # the last three none ((-inf, 0) partials); a row whose mass sits in one
    # slice gives the others' exp(m_r - m) = 0
    assert [hi - lo for lo, hi in slices(9)] == [2, 2, 2, 2, 1, 0, 0, 0]
    x = onp.random.RandomState(1).randn(4, 9).astype("float32")
    x[3] = -50.0
    x[3, 8] = 50.0
    got = model_softmax_wide(x)
    assert float(onp.abs(got - _reference(x)).max()) <= SOFTMAX_TOL
    assert onp.isfinite(got).all()


def test_combine_is_the_same_in_every_block_and_order_fixed():
    # every block reads all eight partials and combines them r = 0..7: the
    # same (m, s) bit for bit, whichever block computes it
    x = onp.random.RandomState(2).randn(50257).astype("float32") * 4
    parts = [partial(x[lo:hi]) for lo, hi in slices(x.size)]
    m, s = combine(parts)
    assert m == x.max()
    want = onp.exp(x.astype("float64") - float(m)).sum()
    assert abs(float(s) - want) <= 1e-6 * want


@pytest.mark.parametrize("vec", [4, 8])   # fp32, bf16 elements a vector
def test_head_body_tail_cover_each_slice_once(vec):
    # every alignment of every slice of an odd width: each element is
    # loaded exactly once, and each body vector lands on an aligned
    # shared-memory slot (c - base a multiple of vec)
    for d in (4097, 50257, 4103):
        for row in range(vec):
            for lo, hi in slices(d):
                mis = (row * d + lo) % vec       # x itself 16-byte aligned
                a0, a1, base = pieces(lo, hi, mis, vec)
                assert a0 - lo < vec and hi - a1 < vec
                assert (a1 - a0) % vec == 0 and (a0 - base) % vec == 0
                assert a0 == hi or (row * d + a0) % vec == 0
                seen = onp.zeros(d, int)
                seen[lo:a0] += 1
                seen[a1:hi] += 1
                for c in range(a0, a1, vec):
                    seen[c:c + vec] += 1
                assert (seen[lo:hi] == 1).all() and seen.sum() == hi - lo
                # shared memory: slice + vec floats hold every index
                assert 0 <= lo - base and hi - base <= (hi - lo) + vec


def test_wide_path_threshold_is_the_kernels():
    # the model's constants are the kernel's: both sides of the threshold
    # are what the card's tests and chip_smoke.py drive
    from pathlib import Path

    src = (Path(__file__).resolve().parent.parent / "mxnet_tpu_torch" /
           "csrc" / "softmax.cu").read_text()
    assert f"constexpr int kWideMinD = {WIDE_MIN_D};" in src
    assert f"constexpr int kCluster = {CLUSTER};" in src
