"""The JAX suite's station end to end (``tests/test_station_e2e.py``) held
against the port.

One two-qubit station -- XY lines with DRAG mixing, Z flux lines with the
exponential-settling pre-compensation, a two-tone readout line -- built
with the JAX package's constructors (the JAX file's
``build_station_schedule``) and with the port's
(``schedules.build_station_schedule``), equal in the wire format, then
driven through gates -> synthesis -> pre-compensation -> demodulation on
every port engine on ``device='cpu'`` (the kernels' plain versions; the
filters' CPU route, the doubling scan).  Each stage is held to the JAX
file's bound against the float64 oracle or scipy (2e-6 of the peak for
synthesis, 5e-5 for the f32 filters, 1e-4 for the IQ points, 1e-9 for the
double tier, one code for int16) and against the JAX package's output of
the same stage.  Every routed call runs under both routing rules: the JAX
package's and the H100's (the ``rule`` fixture).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.signal import lfilter as sp_lfilter

import waveforms_tpu.distortion as dist_j
from waveforms_tpu import engine as engine_j
from waveforms_tpu.ops.demod import demod_matrix as demod_matrix_j
from waveforms_tpu.ops.demod import demodulate as demodulate_j
from waveforms_tpu.ops.iir import lfilter as lfilter_j
from waveforms_tpu.ops.iir import predistort_jax
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import synthesize_device as synth_j
from waveforms_tpu.ops.stack_synth import build_stack_plan as stack_plan_j
from waveforms_tpu.parallel.mesh import channel_mesh as mesh_j
from waveforms_tpu.parallel.mesh import synthesize_on_mesh as on_mesh_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import distortion, schedules
from waveforms_tpu_torch.convert import waveform_from_jax
from waveforms_tpu_torch.core import WaveVStack
from waveforms_tpu_torch.ops import demod_matrix, demodulate, iir
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.stack_synth import build_stack_plan
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from waveforms_tpu_torch.parallel.mesh import (channel_mesh,
                                               synthesize_on_mesh)
from waveforms_tpu_torch.utils.signal import getFTMatrix
from test_station_e2e import FS, SPAN, Z_SETTLE, build_station_schedule
from test_torch_fuzz_engines import rule  # noqa: F401  (the fixture)
from test_torch_synth import TOL_JAX

TOL = 2e-6          # synthesis, of the peak (the JAX file's)
TOL_FILTER = 5e-5   # the f32 flux filters against scipy
TOL_IQ = 1e-4       # the IQ points
TOL_HI = 1e-9       # the double tier
TOL_TORCH = 1e-12   # 'torch' against JAX's 'xla' (tests/test_torch_eval.py)
TOL_FILTER_JAX = 1e-10  # a float64 filter against JAX's (test_torch_signal)


@lru_cache(maxsize=None)
def station():
    """(JAX channels, the port's channels, names, grid, oracle)."""
    chans_j = build_station_schedule()
    chans_t = schedules.build_station_schedule()
    names = sorted(chans_j)
    t = np.arange(0, SPAN, 1 / FS)
    oracle = np.stack([np.asarray(
        (chans_j[n].simplify() if hasattr(chans_j[n], 'wlist')
         else chans_j[n])(t)).real for n in names])
    return ([chans_j[n] for n in names], [chans_t[n] for n in names],
            names, t, oracle)


def rel(out, want):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return float(np.abs(out - want).max() / np.abs(want).max())


@lru_cache(maxsize=None)
def jax_out(eng, **kw):
    chans_j = station()[0]
    return np.asarray(engine_j.synthesize(chans_j, 0, SPAN, FS, engine=eng,
                                          **kw))


def test_station_schedule_is_the_jax_one():
    chans_j, chans_t, names, _, _ = station()
    assert names == sorted(schedules.build_station_schedule())
    assert (schedules.STATION_SPAN, schedules.FS,
            schedules.Z_SETTLE) == (SPAN, FS, Z_SETTLE)
    for w_t, w_j in zip(chans_t, chans_j):
        assert isinstance(w_t, WaveVStack) == hasattr(w_j, 'wlist')
        assert w_t.tolist() == waveform_from_jax(w_j).tolist()


# each port engine -> the JAX engine it is held against, and the bound
ENGINES = {'numpy': ('numpy', 0.0), 'torch': ('xla', TOL_TORCH),
           'native': ('native', 0.0), 'cuda-dense': ('pallas', TOL_JAX),
           'cuda-panel': ('pallas', TOL_JAX),
           'cuda-sparse': ('pallas', TOL_JAX),
           'cuda-stack': ('pallas', TOL_JAX)}


@pytest.mark.parametrize('eng', list(ENGINES))
def test_station_synthesis_every_engine(eng):
    """Every engine but the routed one (below): within TOL of the oracle and
    of the JAX package's counterpart ('numpy' and 'native' bit for bit)."""
    _, chans, _, _, oracle = station()
    jax_eng, tol = ENGINES[eng]
    if eng == 'cuda-stack' and build_stack_plan(
            lower_schedule(chans, 0, SPAN, FS)) is None:
        assert stack_plan_j(lower_j(station()[0], 0, SPAN, FS)) is None
        with pytest.raises(wt.UnsupportedFactor):
            wt.synthesize(chans, 0, SPAN, FS, engine=eng, device='cpu')
        return
    out = wt.synthesize(chans, 0, SPAN, FS, engine=eng, device='cpu')
    assert rel(out, oracle) < TOL, eng
    assert rel(out, jax_out(jax_eng)) <= tol, eng


def test_station_synthesis_routed(rule):  # noqa: F811
    """``engine='auto'`` under each rule, against JAX's 'pallas'."""
    _, chans, _, _, oracle = station()
    out = wt.synthesize(chans, 0, SPAN, FS, device='cpu')
    assert out.dtype == torch.float32
    assert rel(out, oracle) < TOL
    assert rel(out, jax_out('pallas')) <= TOL_JAX


@lru_cache(maxsize=None)
def flux():
    """The Z1 line's oracle, its inverse settling filters, scipy's answer,
    and JAX's f32 device IIR's."""
    _, _, names, _, oracle = station()
    z1 = oracle[names.index('Z1')]
    filters = [distortion.exp_decay_filter(a, tau, FS, inv=True)
               for a, tau in zip(*Z_SETTLE)]
    want = z1.copy()
    for b, a in filters:
        want = sp_lfilter(b, a, want)
    got = jnp.asarray(z1, jnp.float32)
    for b, a in filters:
        got = lfilter_j(jnp.asarray(b, jnp.float32),
                        jnp.asarray(a, jnp.float32), got)
    return z1, filters, want, np.asarray(got, np.float64)


def test_station_flux_predistortion_device_matches_host():
    """Z-line pre-compensation on a CPU tensor: the port's ``lfilter`` in
    f32, one filter after the other as the JAX file runs it, within
    TOL_FILTER of scipy and of JAX's f32 device IIR; and
    ``predistort_device`` with both filters in float64, as the JAX
    package's ``predistort_jax`` runs them (in f32 their combined
    polynomial is several times the peak off scipy in both packages
    alike), within TOL_FILTER of scipy and TOL_FILTER_JAX of JAX's."""
    z1, filters, want, got_j = flux()
    got = torch.tensor(z1, dtype=torch.float32)
    for b, a in filters:
        got = iir.lfilter(np.asarray(b, np.float32),
                          np.asarray(a, np.float32), got, device='cpu')
    assert got.dtype == torch.float32
    assert rel(got, want) < TOL_FILTER
    assert rel(got_j, want) < TOL_FILTER
    assert rel(got, got_j) < TOL_FILTER
    pre = iir.predistort_device(torch.tensor(z1), filters, device='cpu')
    assert pre.dtype == torch.float64
    assert rel(pre, want) < TOL_FILTER
    assert rel(pre, np.asarray(predistort_jax(jnp.asarray(z1), filters))
               ) <= TOL_FILTER_JAX


def test_station_predistort_pipeline_matches_scipy():
    """``distortion.predistort`` (the reference API) over the flux channel:
    finite, its shape, equal to the JAX package's."""
    z1 = flux()[0]
    inv = [distortion.exp_decay_filter(0.02, 3e-6, FS, inv=True)]
    out = distortion.predistort(z1, inv)
    assert np.isfinite(out).all() and out.shape == z1.shape
    np.testing.assert_array_equal(out, dist_j.predistort(
        z1, [dist_j.exp_decay_filter(0.02, 3e-6, FS, inv=True)]))


def test_station_readout_demodulation_consistent(rule):  # noqa: F811
    """The readout line synthesized by the routed kernels and demodulated
    at both tones: within TOL_IQ of the host ``getFTMatrix`` and of JAX's
    synthesis + demodulation; each tone present."""
    chans_j, chans, names, t, oracle = station()
    ri = names.index('RI1')
    freqs = schedules.READOUT_TONES
    n = len(t)
    iq_host = oracle[ri] @ np.asarray(getFTMatrix(freqs, n, sampleRate=FS))
    out = wt.synthesize([chans[ri]], 0, SPAN, FS, device='cpu')
    iq = demodulate(out, demod_matrix(freqs, n, FS, device='cpu'))[0]
    out_j = engine_j.synthesize([chans_j[ri]], 0, SPAN, FS, engine='pallas')
    iq_j = np.asarray(demodulate_j(jnp.asarray(out_j),
                                   demod_matrix_j(freqs, n, FS)))[0]
    assert rel(iq, iq_host) < TOL_IQ
    assert rel(iq, iq_j) < TOL_IQ
    assert np.abs(iq_host).min() > 0


@lru_cache(maxsize=None)
def jax_codes():
    low = lower_j(station()[0], 0, SPAN, FS)
    return np.asarray(synth_j(DeviceJ(low), interpret=True,
                              out_dtype=jnp.int16)).astype(np.int64)


def test_station_full_pipeline_int16_dac(rule):  # noqa: F811
    """The AWG upload path: int16 codes of every channel within one code of
    round(f32 * full scale) of the same route, and of JAX's codes; routed
    and on the dense kernel (the JAX file's)."""
    _, chans, _, _, _ = station()
    low = lower_schedule(chans, 0, SPAN, FS)
    dev = DeviceSchedule(low, 'cpu')
    pairs = [(wt.synthesize(chans, 0, SPAN, FS, device='cpu'),
              wt.synthesize(chans, 0, SPAN, FS, device='cpu',
                            out_dtype=torch.int16)),
             (synthesize_device(dev),
              synthesize_device(dev, out_dtype=torch.int16))]
    for f32, codes in pairs:
        assert codes.dtype == torch.int16
        exp = np.clip(np.round(f32.numpy().astype(np.float64) * 32767.0),
                      -32768, 32767).astype(np.int64)
        codes = codes.numpy().astype(np.int64)
        assert np.abs(codes - exp).max() <= 1
        assert np.abs(codes - jax_codes()).max() <= 1


def test_station_hi_tier_erf_edges(rule):  # noqa: F811
    """The whole station -- erf-edged flux squares included -- through the
    double tier, routed and on K3: float64 within TOL_HI of the oracle and
    of JAX's double tier."""
    _, chans, _, _, oracle = station()
    want = jax_out('pallas', precision='double')
    for eng in ('auto', 'cuda-dense'):
        out = wt.synthesize(chans, 0, SPAN, FS, engine=eng,
                            precision='double', device='cpu')
        assert out.dtype == torch.float64
        assert rel(out, oracle) < TOL_HI, eng
        assert rel(out, want) < TOL_HI, eng


@lru_cache(maxsize=None)
def jax_mesh_out():
    return np.asarray(on_mesh_j(station()[0], 0, SPAN, FS,
                                mesh_j(n_channel=4, n_time=2,
                                       devices=jax.devices()[:8]),
                                interpret=True))


def test_station_synthesis_on_mesh(rule):  # noqa: F811
    """The station through the mesh's router on a (4, 2) mesh of CPU
    shards: within TOL of the oracle and TOL_JAX of JAX's 8-device mesh."""
    _, chans, _, _, oracle = station()
    mesh = channel_mesh(4, 2, devices=['cpu'] * 8)
    out = synthesize_on_mesh(chans, 0, SPAN, FS, mesh).gather()
    assert tuple(out.shape) == oracle.shape
    assert rel(out, oracle) < TOL
    assert rel(out, jax_mesh_out()) <= TOL_JAX
