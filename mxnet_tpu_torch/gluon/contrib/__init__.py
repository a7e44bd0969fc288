"""``gluon.contrib`` of the port (reference: python/mxnet/gluon/contrib/):
:mod:`.data`. The reference's ``estimator`` is a ROADMAP item of its own:
reaching it raises :class:`MXNetError` naming A10 (5)."""
from ...base import MXNetError
from . import data

__all__ = ["data"]


def __getattr__(name):
    if name == "estimator":
        raise MXNetError("gluon.contrib.estimator is not ported yet "
                         "(ROADMAP A10 (5))")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
