"""Host utilities of the port: :func:`freeze`, the signal helpers of
:mod:`.signal` (:func:`getFTMatrix`, :func:`shift`), the LaTeX
formatting of :mod:`..core`, and the profiling hooks of :mod:`.profiling`
(``utils.profiling.trace``, ``annotate``, ``device_event_times``,
``measure_device``), a submodule as in the JAX package."""

from . import profiling  # noqa: F401
from .freeze import freeze
from .signal import getFTMatrix, shift

__all__ = ['freeze', 'getFTMatrix', 'shift']
