"""Deep-freeze arbitrary nested containers (opt-in immutability helper).

Same surface as the reference's ``waveforms/utils.py:9-32``.  The IR itself
is nested tuples and never needs this; it exists for user config payloads.
"""

from __future__ import annotations

from types import MappingProxyType

import numpy as np


def _lock_sparse(x) -> bool:
    """Mark a scipy sparse matrix's backing arrays read-only (if it is one)."""
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    if not isinstance(x, sp.spmatrix):
        return False
    # every format keeps its payload in .data; the index arrays differ
    arrays = ['data']
    if x.format in ('csr', 'csc', 'bsr'):
        arrays += ['indices', 'indptr']
    elif x.format == 'coo':
        arrays += ['row', 'col']
    for name in arrays:
        getattr(x, name).flags.writeable = False
    return True


def freeze(x):
    """Recursively freeze containers; mark array buffers read-only.

    list/tuple -> tuple of frozen items; dict -> read-only mapping proxy;
    set -> frozenset; bytearray -> bytes; ndarray/sparse -> same object with
    ``writeable=False``.  Scalars and unknown types pass through unchanged.
    """
    if isinstance(x, (list, tuple)):
        return tuple(map(freeze, x))
    if isinstance(x, set):
        return frozenset(map(freeze, x))
    if isinstance(x, dict):
        return MappingProxyType({k: freeze(v) for k, v in x.items()})
    if isinstance(x, bytearray):
        return bytes(x)
    if isinstance(x, (np.ndarray, np.matrix)):
        x.flags.writeable = False
    else:
        _lock_sparse(x)
    return x
