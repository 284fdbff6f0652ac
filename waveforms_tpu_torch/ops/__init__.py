"""Host lowering, plans and the synthesis entry points over the kernels.

Submodules are imported where they are used; the double tier's entry
points (:mod:`.hi_synth`) are exported here.
"""

from .hi_synth import (HI_OPS, HiSchedule, classify_hi_route,
                       synthesize_hi, synthesize_hi_panels,
                       synthesize_hi_routed)

__all__ = ['HI_OPS', 'HiSchedule', 'classify_hi_route', 'synthesize_hi',
           'synthesize_hi_panels', 'synthesize_hi_routed']
