"""Descriptor upload and the dense synthesis path.

:class:`DeviceSchedule` holds a lowered schedule's descriptor tensors on
one torch device; :func:`synthesize_device` runs the dense grid kernel over
them (:mod:`..kernels`).  On a CUDA device that is the hand-written kernel
``csrc/synth_dense.cu``; on the CPU it is the kernel's plain version
(:func:`.reference.dense_walk`).  A schedule lowered with
``part='complex'`` runs in pair mode: one pass over the factor products,
two amplitude planes, a complex64 result.

GPU descriptors live in global memory, so the TPU kernel's scalar-memory
budgets (``LoweredSchedule.pallas_ok``) do not apply here.
"""

from __future__ import annotations

import numpy as np
import torch

from .lowering import LoweredSchedule

__all__ = ['DeviceSchedule', 'synthesize_device', 'validate_out_mode',
           'dac_scale_tensor', 'default_rows_per_tile',
           'normalize_out_dtype', 'resolve_device']

# Tile height of the TPU dense grid (measured on TPU v5e, not on the GPU).
# Kept only so that routing computes the same padded occupancy as the JAX
# package (engine.classify_route); the CUDA kernels choose their own tiles.
TUNED_ROWS_PER_TILE = 256


_BY_NAME = {'float32': torch.float32, 'int16': torch.int16,
            'bfloat16': torch.bfloat16, 'float16': torch.float16}


def normalize_out_dtype(out_dtype):
    """``None``/f32 -> ``torch.float32``; int16 -> ``torch.int16``; bf16
    and f16 -> ``torch.bfloat16`` / ``torch.float16``.

    Any spelling whose dtype name is one of these is taken: torch dtypes,
    numpy dtypes and type objects, and the JAX/ml_dtypes ``bfloat16``
    (matched by its name, so neither is imported).  Other integer widths
    and other floats raise ``ValueError``."""
    if out_dtype is None:
        return torch.float32
    if isinstance(out_dtype, torch.dtype):
        name = str(out_dtype).replace('torch.', '')
    elif 'bfloat16' in (out_dtype if isinstance(out_dtype, str) else None,
                        getattr(out_dtype, '__name__', None),
                        str(getattr(out_dtype, 'name', ''))):
        name = 'bfloat16'
    else:
        try:
            name = np.dtype(out_dtype).name
        except TypeError as exc:
            raise ValueError(f"unsupported out_dtype {out_dtype!r}") from exc
    if name in _BY_NAME:
        return _BY_NAME[name]
    if name.startswith(('int', 'uint')):
        raise ValueError("integer output supports int16 only")
    raise ValueError(f"out_dtype must be a float type (float32, bfloat16, "
                     f"float16) or int16, got {out_dtype}")


def resolve_device(device) -> torch.device:
    """A torch device; ``'cuda'`` with no usable GPU raises (the port never
    carries on with the CPU when asked for the card)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch sees no CUDA "
                           "device")
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f"unsupported device {device}")
    return device


def dac_scale_tensor(dtype, dac_scale, n_channels, device):
    """Validated (C,) f32 DAC scale for torch dtype ``dtype`` int16, else
    None."""
    if dtype != torch.int16:
        return None
    scale = torch.as_tensor(np.asarray(dac_scale, np.float32).reshape(-1))
    if scale.shape[0] == 1:
        scale = scale.expand(n_channels)
    if scale.shape != (n_channels,):
        raise ValueError(f"dac_scale must be scalar or length-{n_channels}")
    return scale.contiguous().to(device)


def validate_out_mode(out_dtype, n_channels, dac_scale, device,
                      pair=False):
    """One output-mode gate for every entry point: returns
    ``(torch dtype of the output, scale or None)``; the scale is int16's
    only (bf16/f16 stores ignore ``dac_scale``, as in JAX).  Pair mode (a
    schedule lowered with ``part='complex'``) needs f32 accumulation and
    returns ``torch.complex64``, as the JAX package's
    ``validate_out_mode``."""
    dt = normalize_out_dtype(out_dtype)
    if pair:
        if dt != torch.float32:
            raise ValueError("pair-mode (complex) synthesis requires f32 "
                             "output")
        return torch.complex64, None
    return dt, dac_scale_tensor(dt, dac_scale, n_channels, device)


def default_rows_per_tile(n_samples, bucket_samples=0, n_buckets=1,
                          divides=0):
    """The JAX dense grid's tile height for this schedule (largest power of
    two <= 256 that divides the bucket, divides an enclosing chunk of
    ``divides`` rows (streaming), and fits the sample count); used by
    routing and by the streaming generator's argument checks."""
    R = TUNED_ROWS_PER_TILE
    while R > 8:
        tile = R * 128
        if ((n_buckets <= 1 or bucket_samples % tile == 0)
                and (not divides or divides % R == 0)
                and 2 * n_samples >= tile):
            return R
        R //= 2
    return 8


class DeviceSchedule:
    """A lowered schedule's descriptor tensors on one torch device.

    Shapes follow :class:`.lowering.LoweredSchedule` (contiguous, int32 or
    f32); ``seg_hmax`` is the running max of ``seg_hi`` per bucket list, the
    dense kernel's bisect key.  Opcodes stay the lowering's own numbers.
    ``amp_im`` is the second amplitude plane of a ``part='complex'``
    lowering (pair mode), else None.  ``device='cuda'`` without a GPU
    raises (:func:`resolve_device`); pass ``device='cpu'`` for the plain
    versions.
    """

    _TENSORS = ('seg_lo', 'seg_hi', 'seg_hmax', 'nterm', 'nfac', 'amp', 'op',
                'power', 'shift_hi', 'q32', 'args', 'ext', 'clip', 'amp_im')

    def __init__(self, low: LoweredSchedule, device='cuda'):
        self.device = resolve_device(device)
        self.shape = tuple(int(v) for v in low.shape)
        self.n_samples = int(low.n_samples)
        self.bucket_samples = int(low.bucket_samples)
        ext = np.zeros(max(int(low.ext.size) if low.ext is not None else 0,
                           1), np.float32)
        if low.ext is not None and low.ext.size:
            ext[:low.ext.size] = low.ext
        hmax = np.maximum.accumulate(low.seg_hi, axis=-1)
        clip = np.stack([low.clip_min, low.clip_max], axis=1)

        def put(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        self.seg_lo = put(low.seg_lo, np.int32)
        self.seg_hi = put(low.seg_hi, np.int32)
        self.seg_hmax = put(hmax, np.int32)
        self.nterm = put(low.nterm, np.int32)
        self.nfac = put(low.nfac, np.int32)
        self.amp = put(low.amp, np.float32)
        self.op = put(low.op, np.int32)
        self.power = put(low.power, np.int32)
        self.shift_hi = put(low.shift_hi, np.int32)
        self.q32 = put(low.q32, np.int32)
        self.args = put(low.args, np.float32)
        self.ext = put(ext, np.float32)
        self.clip = put(clip, np.float32)
        self.amp_im = (None if low.amp_im is None
                       else put(low.amp_im, np.float32))

    @classmethod
    def from_tensors(cls, shape, n_samples, bucket_samples, **tensors):
        """A DeviceSchedule over descriptor tensors that are already on one
        device (a slice or a concatenation of a sequence table), with no
        copy through the host.  ``tensors`` names every attribute of
        :attr:`_TENSORS` in the layout of ``shape``; ``amp_im`` may be
        None, and so may ``seg_hmax`` where no dense walk reads it."""
        missing = set(cls._TENSORS) - {'amp_im', 'seg_hmax'} - set(tensors)
        if missing or set(tensors) - set(cls._TENSORS):
            raise ValueError(f"from_tensors takes exactly {cls._TENSORS}")
        self = cls.__new__(cls)
        self.device = tensors['seg_lo'].device
        self.shape = tuple(int(v) for v in shape)
        self.n_samples = int(n_samples)
        self.bucket_samples = int(bucket_samples)
        for name in cls._TENSORS:
            setattr(self, name, tensors.get(name))
        return self


def synthesize_device(dev: DeviceSchedule, out_dtype=None,
                      dac_scale=32767.0) -> torch.Tensor:
    """Run the dense kernel on ``dev`` -> (C, n_samples) on ``dev.device``.

    ``out_dtype=torch.int16`` emits DAC codes
    ``clip(round_half_even(x * dac_scale))``; ``dac_scale`` is a scalar or a
    per-channel vector.  ``torch.bfloat16`` / ``torch.float16`` store the
    f32 sum rounded once to nearest even.  A pair-mode schedule gives
    complex64.  Accumulation is f32 either way."""
    from .. import kernels
    C = dev.shape[0]
    dt, scale = validate_out_mode(out_dtype, C, dac_scale, dev.device,
                                  pair=dev.amp_im is not None)
    out = torch.empty((C, dev.n_samples), dtype=dt, device=dev.device)
    return kernels.synth_dense(dev, out, scale)

