"""Host lowering, plans and the synthesis entry points over the kernels.

Submodules are imported where they are used; the double tier's entry
points (:mod:`.hi_synth`) and the sequence tables (:mod:`.sequencer`,
:mod:`.stack_seq`) are exported here.
"""

from .hi_synth import (HI_OPS, HiSchedule, classify_hi_route,
                       synthesize_hi, synthesize_hi_panels,
                       synthesize_hi_routed)
from .sequencer import Sequencer
from .stack_seq import StackSequencer

__all__ = ['HI_OPS', 'HiSchedule', 'classify_hi_route', 'synthesize_hi',
           'synthesize_hi_panels', 'synthesize_hi_routed', 'Sequencer',
           'StackSequencer']
