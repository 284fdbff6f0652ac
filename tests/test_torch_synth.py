"""The dense kernel's plain PyTorch version against the JAX kernel.

The same lowered schedule goes through the JAX dense kernel (Pallas, in
interpret mode as the JAX suite runs it on the CPU, rows_per_tile=8) and
through the port's dense path on ``device='cpu'``, which is the plain
version of ``csrc/synth_dense.cu`` (``ops.reference.dense_walk``).

Tolerances: <= 1e-6 of each channel's peak against the JAX kernel (both
compute in f32 with the same formulas; only transcendental implementations
and rounding order differ), and the JAX suite's own RTOL against the
float64 oracle (2e-6; 5e-6 where tests/test_pallas_synth.py uses it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import synthesize_device as synth_j
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops.lowering import (OP_EXPCHIRP, OP_HYPCHIRP,
                                              OP_INTERP)
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from test_torch_lowering import opcode_cases

TOL_JAX = 1e-6
RTOL = 2e-6
ORACLE_TOL = {'chirps': 5e-6, 'multitone_drag': 5e-6}


def rel(a, b):
    """Max over channels of max|a - b| / max|b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def port_dense(low_j, **kw):
    dev = DeviceSchedule(lowered_from_jax(low_j), 'cpu')
    return synthesize_device(dev, **kw).numpy()


def oracle(chans, start, stop, fs):
    t = np.arange(start, stop, 1 / fs)
    return np.stack([np.asarray(w(t)) for w in chans])


@pytest.mark.parametrize('case', list(opcode_cases(wj)))
def test_dense_walk_matches_jax_and_oracle(case):
    chans, start, stop, fs, bs = opcode_cases(wj)[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    ref = np.asarray(synth_j(DeviceJ(low), rows_per_tile=8, interpret=True))
    got = port_dense(low)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel(got, ref) <= TOL_JAX
    assert rel(got, oracle(chans, start, stop, fs)) <= ORACLE_TOL.get(
        case, RTOL)


def test_long_carrier_phase_accuracy():
    """Carrier phase over 2M samples (1 ms at 2 GS/s): the int32 turn
    arithmetic, wrapped in int64 by the plain version."""
    chans = [wj.cos(2 * np.pi * 137.137e6, 0.3),
             wj.gaussian(2.5e-3) * wj.cos(2 * np.pi * 250e6)]
    low = lower_j(chans, 0, 1e-3, 2e9)
    out = port_dense(low)
    t = np.arange(0, 1e-3, 0.5e-9)
    tail = slice(-100000, None)
    for i, ch in enumerate(chans):
        assert np.abs(out[i][tail] - ch(t[tail])).max() < 2e-6


def test_every_opcode_formula():
    """OP_EXPCHIRP, OP_HYPCHIRP and the reserved OP_INTERP never reach a
    sampled segment through the lowering, so they are set directly into a
    gaussian schedule's descriptors; both kernels' versions must agree."""
    low = lower_j([wj.gaussian(1e-6)] * 3, -1e-6, 1e-6, 1e9)
    for c, op in enumerate((OP_EXPCHIRP, OP_HYPCHIRP, OP_INTERP)):
        low.op[c, 0, 0, 0, 0] = op
        low.args[c, 0, 0, 0, 0, 1:4] = (2 * np.pi * 0.1, 1e-3, 0.3)
    ref = np.asarray(synth_j(DeviceJ(low), rows_per_tile=8, interpret=True))
    got = port_dense(low)
    assert np.isfinite(got).all()
    assert rel(got, ref) <= TOL_JAX


@pytest.mark.parametrize('case', ['basic_shapes', 'multi_bucket'])
def test_int16_codes(case):
    """int16 codes equal clip(round_half_even(f32 * scale)) of the port's
    own f32 output, and lie within one code of the JAX kernel's codes."""
    chans, start, stop, fs, bs = opcode_cases(wj)[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    scales = np.linspace(16000.0, 32767.0, low.shape[0]).astype(np.float32)
    f32 = port_dense(low)
    codes = port_dense(low, out_dtype=torch.int16, dac_scale=scales)
    assert codes.dtype == np.int16
    expected = np.clip(np.round(f32 * scales[:, None]), -32768, 32767)
    np.testing.assert_array_equal(codes, expected.astype(np.int16))
    ref = np.asarray(synth_j(DeviceJ(low), rows_per_tile=8, interpret=True,
                             out_dtype=jnp.int16, dac_scale=scales))
    assert np.abs(codes.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_int16_clamps_and_validates():
    chans = [0.9 * wj.cosPulse(100e-9) >> 300e-9,
             1.2 * (wj.square(200e-9) >> 300e-9)]   # overdrive: clamps
    low = lower_j(chans, 0, 1.024e-6, 2e9)
    codes = port_dense(low, out_dtype=np.int16)
    assert codes[1].max() == 32767
    dev = DeviceSchedule(lowered_from_jax(low), 'cpu')
    with pytest.raises(ValueError, match='int16 only'):
        synthesize_device(dev, out_dtype=torch.int32)
    with pytest.raises(ValueError, match='dac_scale'):
        synthesize_device(dev, out_dtype=torch.int16, dac_scale=[1.0] * 3)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel: its launch count stays put."""
    low = lower_j([wj.gaussian(1e-6)], -1e-6, 1e-6, 1e9)
    before = kernels.launch_counts()
    port_dense(low)
    assert kernels.launch_counts() == before

