"""The shot pipeline: synthesize -> predistort -> demodulate
(:mod:`.pipeline`).  The multi-device parts of the JAX package's
``waveforms_tpu/parallel`` (meshes, sharded synthesis, ``make_step`` and
``run_step``) are not ported yet."""

from .pipeline import run_sequence

__all__ = ['run_sequence']
