"""``engine='auto'``'s routing rule, one for each kind of device.

Three routers pick a synthesis kernel for a lowered schedule from the same
facts -- the live-subtile occupancy of its sparse plan, its size in dense-
kernel tiles, and the merits of its stack plan -- against a
:class:`RouteRule`: :func:`..engine.classify_route` (f32, int16, bf16/f16
and pair mode), :func:`.hi_synth.classify_hi_route`
(``precision='double'``) and :func:`..parallel.mesh.synthesize_on_mesh`.

* :data:`JAX_RULE` is the JAX package's router with its values, which its
  TPU occupancy ladder fixed (``tools/tpu_capture.py`` ``task_occ_ladder``
  and ``task_occ_ladder_stack``).  CPU devices take it, so that their
  routes agree with JAX's.
* :data:`CARD_RULE` is the H100's, read off the same ladder run on the card
  (:mod:`..route_ladder`).  CUDA devices take it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import DENSE_TILE
from .sparse_synth import (PANEL_OCCUPANCY_THRESHOLD,
                           SPARSE_OCCUPANCY_THRESHOLD)
from .stack_synth import DEFAULT_ADVANTAGE, STACK_MIN_NARROW, STACK_OCC_FLOOR
from .synth import default_rows_per_tile, normalize_out_dtype

__all__ = ['Band', 'RouteRule', 'JAX_RULE', 'CARD_RULE', 'rule_for', 'facts',
           'padded_occupancy', 'stack_first', 'store_kind',
           'takes_worklist', 'stack_wins']

INF = float('inf')


@dataclass(frozen=True)
class Band:
    """A rule's thresholds for schedules of fewer than ``tiles`` dense-kernel
    tiles (``kernels.DENSE_TILE`` samples of one channel: a thread block of
    K1) over all channels."""
    tiles: float
    # the stack kernel first from this occupancy, where its plan wins;
    # None: not first
    stack: float | None
    # the worklist kernel below this occupancy, by store (store_kind): f32,
    # a two-byte store (int16, bf16, f16), pair mode
    worklist: tuple[float, float, float]


@dataclass(frozen=True)
class RouteRule:
    """The thresholds of ``engine='auto'`` on one kind of device (the steps
    they enter are :func:`..engine.classify_route`'s)."""
    bands: tuple[Band, ...]  # by size, the last one unbounded
    panel_occ: float        # the panel kernels (K2, K4) below this occupancy
    stack_advantage: float  # a stack plan wins with at least this advantage
    stack_min_narrow: int   # ... and this many narrow instances
    # the TPU's own: occupancy over the TPU dense grid's padded tiles and
    # its ``small`` window (at most two of them a channel, which the panel
    # kernel takes), the stack kernel as the last resort before the dense
    # one, and the TPU's descriptor budget (``pallas_ok``) steering
    # ``force=None``
    tpu: bool


JAX_RULE = RouteRule(
    bands=(Band(INF, STACK_OCC_FLOOR, (SPARSE_OCCUPANCY_THRESHOLD,) * 3),),
    panel_occ=PANEL_OCCUPANCY_THRESHOLD, stack_advantage=DEFAULT_ADVANTAGE,
    stack_min_narrow=STACK_MIN_NARROW, tpu=True)

# The H100's, read off the route ladder (route_ladder's record; NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md section 5), the live-subtile fraction its
# occupancy.  No rung runs fastest on the panel kernel, and K3 ties or
# beats K4 on every rung but ladder60's one bucket (K4 by 4%): neither
# panel kernel is an ``auto`` route.  Two bands:
# * under 512 tiles (station, midband: 50; flagship_16k: 256) K1, one
#   launch, is fastest: the stack kernel takes up to 4.8x its time;
# * from 512 (every 128-channel rung and stratum: 16,384 tiles and up) the
#   stack kernel first from the JAX rule's floor, STACK_OCC_FLOOR, where
#   the JAX router builds the stack plan too.  Below it the stack kernel
#   is 1.1-1.3x faster (ladder10, ladder25, mid), but its plan costs
#   0.1-0.3 s of host time against the 0.01-0.07 ms it saves.  The
#   worklist path below 0.015 in f32 and pair mode (the flagship, 0.0073;
#   K1 within 2% of it either way up to ladder25's 0.10) and below 0.3
#   with a two-byte store (K1 1.1-1.6x its time from 0.0073 to ladder60's
#   0.223, 0.91x at ladder120's 0.392); K1 else, and at occupancy 1.
CARD_RULE = RouteRule(
    bands=(Band(512, None, (0.0, 0.0, 0.0)),
           Band(INF, STACK_OCC_FLOOR, (0.015, 0.3, 0.015))),
    panel_occ=0.0, stack_advantage=DEFAULT_ADVANTAGE,
    stack_min_narrow=STACK_MIN_NARROW, tpu=False)


def rule_for(device) -> RouteRule:
    """:data:`CARD_RULE` for a CUDA device, :data:`JAX_RULE` for None or a
    CPU device."""
    if device is not None and torch.device(device).type == 'cuda':
        return CARD_RULE
    return JAX_RULE


def padded_occupancy(low, sparse_plan) -> tuple[float, bool]:
    """The JAX router's occupancy of a lowering -> ``(occ, small)``: the live
    subtile fraction of ``sparse_plan`` against the PADDED tile count of
    the JAX dense grid, and whether the schedule is at most two of those
    tiles (``small``: too short for the stack kernel to amortize
    anything)."""
    NB = low.shape[1]
    R = default_rows_per_tile(low.n_samples, low.bucket_samples, NB)
    n_rows = -(-low.n_samples // 128)
    padded_rows = -(-n_rows // R) * R
    occ = sparse_plan.occupied_fraction * n_rows / padded_rows
    return occ, padded_rows <= 2 * R


def facts(low, sparse_plan, rule: RouteRule = JAX_RULE):
    """``(occ, small, band)`` of a lowering under ``rule``: its occupancy,
    whether it is the TPU rule's ``small`` window, and its :class:`Band`."""
    if rule.tpu:
        return (*padded_occupancy(low, sparse_plan), rule.bands[0])
    tiles = low.shape[0] * -(-low.n_samples // DENSE_TILE)
    return (sparse_plan.occupied_fraction, False,
            next(b for b in rule.bands if tiles < b.tiles))


def stack_first(occ, small, band: Band) -> bool:
    """Whether the stack kernel is tried before the others (step 1 of
    :func:`..engine.classify_route`)."""
    return band.stack is not None and not small and occ >= band.stack


def store_kind(out_dtype, pair: bool) -> int:
    """An output mode's index into :attr:`Band.worklist`: 0 f32, 1 a
    two-byte store (int16, bf16, f16), 2 pair mode."""
    if pair:
        return 2
    return int(normalize_out_dtype(out_dtype) != torch.float32)


def takes_worklist(occ, band: Band, store: int) -> bool:
    """Whether the worklist kernel takes what the stack and panel kernels
    did not (step 3); ``store`` is :func:`store_kind`'s."""
    return occ < band.worklist[store]


def stack_wins(plan, rule: RouteRule = JAX_RULE) -> bool:
    """Whether a StackPlan takes the stack route on its merits under
    ``rule``: enough narrow instances and a large enough advantage."""
    return (plan is not None and plan.n_narrow >= rule.stack_min_narrow
            and plan.advantage >= rule.stack_advantage)
