"""Multi-device synthesis and the shot pipeline.

:mod:`.mesh`: a single-process ('channel', 'time') mesh of torch devices
(:func:`channel_mesh`), each shard's descriptors on its device
(:func:`shard_schedule`), the dense kernel over the mesh
(:func:`synthesize_sharded`) and the router over the sharded kernels
(:func:`synthesize_on_mesh`).  :mod:`.pipeline`: the sharded production step
(:func:`make_step`, :func:`run_step`) and a shot table on one device
(:func:`run_sequence`).
"""

from .mesh import (Mesh, ShardedPlane, channel_mesh, shard_schedule,
                   synthesize_on_mesh, synthesize_sharded)
from .pipeline import make_step, run_sequence, run_step

__all__ = ['Mesh', 'ShardedPlane', 'channel_mesh', 'shard_schedule',
           'synthesize_sharded', 'synthesize_on_mesh', 'make_step',
           'run_step', 'run_sequence']
