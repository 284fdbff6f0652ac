"""Multi-device synthesis and the shot pipeline.

:mod:`.mesh`: a ('channel', 'time') mesh of torch devices
(:func:`channel_mesh`), in one process or over several, each shard's
descriptors on its device (:func:`shard_schedule`), the dense kernel over
the mesh (:func:`synthesize_sharded`) and the router over the sharded
kernels (:func:`synthesize_on_mesh`).  :mod:`.distributed`: the process
group and the exchanges of a mesh that spans processes.  :mod:`.pipeline`:
the sharded production step (:func:`make_step`, :func:`run_step`) and a
shot table on one device (:func:`run_sequence`: one CUDA graph a shot on
the card, :class:`SequenceGraph`; the host loop
:func:`run_sequence_loop`).
:mod:`.multiproc_smoke`: the two-process smoke run.
"""

from . import distributed
from .mesh import (Mesh, ShardedPlane, channel_mesh, shard_schedule,
                   synthesize_on_mesh, synthesize_sharded)
from .pipeline import (SequenceGraph, make_step, run_sequence,
                       run_sequence_loop, run_step)

__all__ = ['Mesh', 'ShardedPlane', 'channel_mesh', 'shard_schedule',
           'synthesize_sharded', 'synthesize_on_mesh', 'make_step',
           'run_step', 'run_sequence', 'run_sequence_loop', 'SequenceGraph',
           'distributed']
