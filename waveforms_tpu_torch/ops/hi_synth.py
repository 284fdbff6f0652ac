"""The double tier (``precision='double'``): the <= 1e-9 contract.

The counterpart of ``waveforms_tpu.ops.hi_synth``.  The JAX package runs
this tier in double-f32 because the TPU's vector unit has no f64 datapath;
the H100 has one, so both kernels here compute in native float64:

* :func:`synthesize_hi` runs the dense kernel ``csrc/synth_dense_hi.cu``
  (K3) over every sample, any number of buckets;
* :func:`synthesize_hi_panels` runs the panel kernel
  ``csrc/synth_panel_hi.cu`` (K4) over the live subtiles of a
  single-bucket schedule, zeros elsewhere;
* :func:`synthesize_hi_routed` picks between them by the f32 router's
  occupancy rule, with the thresholds of the schedule's device
  (:func:`classify_hi_route`; on the card K3 throughout, the H100's
  occupancy ladder finding K4 no faster).

On CPU tensors the kernels' plain versions run (:mod:`.reference_hi`).
Inputs come from ``lower_schedule(..., keep_f64=True)``: ``args + args_lo``
and ``amp + amp_lo`` are uploaded as float64, with the f64 ``ext``.
``combine=True`` returns a float64 tensor (C, n) on the schedule's device;
``combine=False`` the f32 planes ``(hi, lo)`` with ``hi = f32(x)`` and
``lo = f32(x - hi)``, whose f64 sum is the result.

The TPU's levers (``rows_per_tile``, ``interpret``) and its scalar-memory
budgets are not carried over: GPU descriptors and worklists live in global
memory.  Nor is the TPU's windowed panel route: the port's output is one
buffer (see ``engine.classify_route``).
"""

from __future__ import annotations

import numpy as np
import torch

from .lowering import (OP_COS, OP_COSH, OP_DRAG, OP_DRAG_SIN, OP_DRAG_SINX,
                       OP_ERF, OP_EXP, OP_GAUSSIAN, OP_LINEAR, OP_LINEARCHIRP,
                       OP_MOLLIFIER, OP_POLY_GAUSS, OP_SINC, OP_SINH,
                       LoweredSchedule, UnsupportedFactor)
from .routes import facts, rule_for
from .sparse_synth import (PanelPlan, PanelWork, _validate_panel_plan,
                           build_panel_plan, build_sparse_plan)
from .synth import resolve_device

__all__ = ['HI_OPS', 'HiSchedule', 'check_hi_schedule', 'synthesize_hi',
           'synthesize_hi_panels', 'synthesize_hi_routed',
           'classify_hi_route']

HI_OPS = frozenset({OP_LINEAR, OP_GAUSSIAN, OP_COS, OP_EXP, OP_SINC,
                    OP_DRAG, OP_LINEARCHIRP, OP_ERF, OP_COSH, OP_SINH,
                    OP_POLY_GAUSS, OP_MOLLIFIER, OP_DRAG_SIN,
                    OP_DRAG_SINX})


def check_hi_schedule(low: LoweredSchedule) -> None:
    """The double tier's gates, before any upload: a ``keep_f64`` lowering
    (else ``ValueError``), real amplitudes and only ``HI_OPS`` in live
    factor slots (else :class:`UnsupportedFactor`), as the JAX
    ``HiSchedule``."""
    if low.args_lo is None or low.amp_lo is None:
        raise ValueError(
            "hi-tier synthesis needs lower_schedule(..., keep_f64=True)")
    if low.amp_im is not None:
        raise UnsupportedFactor("the double tier is real-only; "
                                "part='complex' runs on engine='numpy'")
    live = np.arange(low.shape[4]) < low.nfac[..., None]
    bad = {int(o) for o in np.unique(low.op[live])} - HI_OPS
    if bad:
        raise UnsupportedFactor(
            f"opcodes {sorted(bad)} have no double-tier formula; use "
            "engine='numpy'")


class HiSchedule:
    """A ``keep_f64`` lowering's descriptors on one torch device.

    The int32 tensors are :class:`.synth.DeviceSchedule`'s; ``amp64`` and
    ``args64`` are ``amp + amp_lo`` and ``args + args_lo`` in float64,
    ``ext64`` the f64 ext side buffer, ``clip`` the (C, 2) f32 rails.
    Dead factor slots keep their opcodes: the kernels read only live ones.
    """

    def __init__(self, low: LoweredSchedule, device='cuda'):
        check_hi_schedule(low)
        self.device = resolve_device(device)
        self.shape = tuple(int(v) for v in low.shape)
        self.n_samples = int(low.n_samples)
        self.bucket_samples = int(low.bucket_samples)
        n_ext = int(low.ext.size) if low.ext is not None else 0
        ext = np.zeros(max(n_ext, 1), np.float64)
        if n_ext:
            ext[:n_ext] = low.ext

        def put(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        def f64(hi, lo):
            return hi.astype(np.float64) + lo.astype(np.float64)

        self.seg_lo = put(low.seg_lo, np.int32)
        self.seg_hi = put(low.seg_hi, np.int32)
        self.seg_hmax = put(np.maximum.accumulate(low.seg_hi, axis=-1),
                            np.int32)
        self.nterm = put(low.nterm, np.int32)
        self.nfac = put(low.nfac, np.int32)
        self.amp64 = put(f64(low.amp, low.amp_lo), np.float64)
        self.op = put(low.op, np.int32)
        self.power = put(low.power, np.int32)
        self.shift_hi = put(low.shift_hi, np.int32)
        self.q32 = put(low.q32, np.int32)
        self.args64 = put(f64(low.args, low.args_lo), np.float64)
        self.ext64 = put(ext, np.float64)
        self.clip = put(np.stack([low.clip_min, low.clip_max], axis=1),
                        np.float32)


def _outputs(C, n, device, combine):
    """(out, lo): one f64 plane, or the f32 hi and lo planes."""
    if combine:
        return torch.empty((C, n), dtype=torch.float64, device=device), None
    return (torch.empty((C, n), dtype=torch.float32, device=device),
            torch.empty((C, n), dtype=torch.float32, device=device))


def synthesize_hi(low_or_dev, combine: bool = True, device='cuda'):
    """Dense double-tier synthesis (K3) -> float64 (C, n_samples) on the
    schedule's device, or with ``combine=False`` the f32 ``(hi, lo)``
    planes.  ``device`` places a LoweredSchedule's upload; cache the
    :class:`HiSchedule` for repeated runs."""
    from .. import kernels
    dev = (low_or_dev if isinstance(low_or_dev, HiSchedule)
           else HiSchedule(low_or_dev, device))
    out, lo = _outputs(dev.shape[0], dev.n_samples, dev.device, combine)
    kernels.synth_dense_hi(dev, out, lo)
    return out if combine else (out, lo)


def synthesize_hi_panels(dev, low: LoweredSchedule | None = None,
                         plan: PanelPlan | None = None, Rs: int = 32,
                         combine: bool = True, device='cuda'):
    """Panel double-tier synthesis (K4) of a single-bucket schedule ->
    float64 (C, window_samples), or the f32 ``(hi, lo)`` planes.  ``dev``
    is a HiSchedule or a LoweredSchedule (uploaded to ``device``); the
    plan comes from ``plan`` or is built from the lowering."""
    from .. import kernels
    if not isinstance(dev, HiSchedule):
        low = low or dev
        dev = HiSchedule(dev, device)
    if dev.shape[1] != 1:
        raise UnsupportedFactor("hi panel synthesis is single-bucket; "
                                "bucketed schedules run the dense hi kernel")
    if plan is None:
        if low is None:
            raise ValueError("synthesize_hi_panels needs `low` or `plan`")
        plan = build_panel_plan(low, Rs=Rs)
    _validate_panel_plan(plan, dev)
    out, lo = _outputs(dev.shape[0], plan.window_samples, dev.device,
                       combine)
    kernels.synth_panel_hi(dev, PanelWork.upload(plan, dev.device), out, lo)
    return out if combine else (out, lo)


def classify_hi_route(low: LoweredSchedule, device=None):
    """The double tier's route -> ``('panel', PanelPlan)`` or ``('dense',
    None)``, by the rule of the JAX ``synthesize_hi_routed`` with the
    thresholds of ``device``'s :class:`.routes.RouteRule` (the JAX
    package's for None or a CPU device, the H100's for a CUDA device): a
    single-bucket real schedule goes to the panel kernel when its
    occupancy is below the rule's ``panel_occ`` or its window is the
    JAX rule's ``small``, as in ``engine.classify_route``; everything else
    goes dense.  Under the JAX rule the schedule must also be within the
    TPU's descriptor budget (``pallas_ok``, kept so that the routes
    agree)."""
    rule = rule_for(device)
    if (low.shape[1] == 1 and (low.pallas_ok or not rule.tpu)
            and low.amp_im is None):
        try:
            sp = build_sparse_plan(low)
        except UnsupportedFactor:
            return 'dense', None
        occ, small, _ = facts(low, sp, rule)
        if small or occ < rule.panel_occ:
            return 'panel', build_panel_plan(low, base=sp)
    return 'dense', None


def synthesize_hi_routed(low: LoweredSchedule, combine: bool = True,
                         device='cuda'):
    """Occupancy-routed double tier: the panel kernel or the dense kernel,
    as :func:`classify_hi_route` picks."""
    dev = HiSchedule(low, device)
    kind, plan = classify_hi_route(low, dev.device)
    if kind == 'panel':
        return synthesize_hi_panels(dev, plan=plan, combine=combine)
    return synthesize_hi(dev, combine=combine)
