"""Host utilities of the port: :func:`freeze`, the signal helpers of
:mod:`.signal` (:func:`getFTMatrix`, :func:`shift`) and the LaTeX
formatting of :mod:`..core`."""

from .freeze import freeze
from .signal import getFTMatrix, shift

__all__ = ['freeze', 'getFTMatrix', 'shift']
