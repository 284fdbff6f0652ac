"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one (the kernels have no
CPU mode).  The file imports neither ``jax`` nor ``waveforms_tpu``, so it
also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Inputs come from the port's own constructors with fixed seeds.  Each kernel
is held to its plain PyTorch version on the CPU (which the other
test_torch_* files hold to the JAX kernels) within 1e-6 of each channel's
peak (pair mode: of each plane's peak), and int16 codes to exactly the
kernel's own f32 output quantized, or within one code of the plain
version's.  The double tier's float64 kernels (K3, K4) are held to their
plain float64 versions within 1e-12 of each channel's peak.  The probe
kernels P2, P3 and P4 (f32 add chains) are held to their plain versions
bit for bit, P1's compact worklist kernel within 1e-6 of each channel's
peak.  K1 and K3 on a grid wide enough for K1's 8-samples-a-thread layout
are held to their small-grid launches of the same channels bit for bit.
K7 and P1, which walk with K1's tile walker, are held to K1 and to each
other bit for bit on every live subtile, at subtile heights of 1, 3, 8 and
32 rows and on a worklist of more items than a grid's y axis holds.  K1's
windows (row0, n_out) are held to the same columns of its unwindowed
launch bit for bit.  K1 over a time shard's slice of the bucket axis
(``bucket0``) and K6 over a window of chunks are held to the same columns
of their whole launches bit for bit and to their plain versions, K1 at
``bucket0 = 0`` and K6 over a whole table to a parent build's outputs bit
for bit (where one is unpacked under build/parent), and each sharded route
on a (2, 2) mesh of one card to its kernel on the whole schedule.  The IIR
recurrence kernel S1, a blocked scan, is held
bit for bit to the plain model of its arithmetic (``df2t_blocked``) and,
over each row's first chunk, to its sequential plain version, in f64 and
f32 (neither contracts a multiply-add), and no farther from a long-double
answer than the sequential version; an f32 demodulation to itself with
TF32 on.  K1's and K7's shot entries (one launch for a shot vector over a
sequence table, the index read on the card) are held shot by shot to
one-shot launches bit for bit and to their plain versions as above; a shot
vector drawn on the card plays under ``torch.cuda.set_sync_debug_mode(
'error')``, and ``play_replay`` clamps a card index there; ``run_sequence``'s
CUDA graph (a single shot: its eager shot, uncaptured) equals its host loop
bit for bit.  The trace evaluator's kernel T1 is held to its plain
version on the CPU (the same tape) within 1e-12 of each channel's peak in
float64 (1e-6 on a float32 grid), and to the float64 oracle at the JAX
suite's bounds, on every case of ``ops.trace_cases`` (among them grids
that cross its tiles of 2,048 samples); on grids with NaN and infinite
samples (NaN-equal, a NaN sample outside every segment unless the waveform
is one unbounded segment) and on odd sample counts in every output mode and
in float32; a permuted grid's output is the sorted grid's output permuted,
bit for bit; ``synthesize(engine='torch')``, ``sample_waveform`` and the
CLI's default path each launch it once a call and nothing else.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import waveforms_tpu_torch as wt
from waveforms_tpu_torch import kernels, probes
from waveforms_tpu_torch.ops import iir_cases, torch_eval, trace_cases
from waveforms_tpu_torch.ops.hi_synth import (HiSchedule, synthesize_hi,
                                              synthesize_hi_panels)
from waveforms_tpu_torch.ops.lowering import (OP_EXPCHIRP, OP_HYPCHIRP,
                                              lower_schedule)
from waveforms_tpu_torch.ops.reference_probes import WALKER_BODIES
from waveforms_tpu_torch.ops.sparse_synth import (SparseWork,
                                                  build_panel_plan,
                                                  build_sparse_plan,
                                                  synthesize_panels,
                                                  synthesize_sparse)
from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                 synthesize_stack)
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from waveforms_tpu_torch.schedules import build_dense_schedule

pytestmark = pytest.mark.cuda

TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device('cuda')


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def _cases():
    bf = (151e6, -83e6, 217e6)
    rng = np.random.default_rng(9)
    stack = wt.WaveVStack([(0.4 * wt.cosPulse(40e-9) >> o)
                           for o in rng.uniform(0, 7e-6, 60)])
    I, _ = wt.mixing(0.5 * wt.cosPulse(20e-9) >> 1e-7, freq=-20e6,
                     DRAGScaling=1e-10)
    return {
        'shapes': ([wt.gaussian(1e-6), wt.cosPulse(1e-6),
                    wt.square(1e-6, edge=0.2e-6), wt.sinc(20e6),
                    wt.cosh(1e6) * wt.square(2e-6),
                    wt.mollifier(1e-6, d=2), wt.gaussian(1e-6, d=2),
                    wt.poly([0.5, 1e5, -1e11]) * wt.square(3e-6)],
                   -2e-6, 2e-6, 1e9, 'auto'),
        'mixing_drag': ([I, wt.drag(100e6, 20e-9, plateau=10e-9, delta=2e6,
                                    block_freq=250e6, phase=0.4,
                                    t0=3e-9) >> 0.1e-6],
                        -0.1e-6, 0.4e-6, 2e9, 'auto'),
        'chirps': ([wt.chirp(1e6, 50e6, 1e-5, 0.3, 'linear'),
                    wt.chirp(1e6, 50e6, 1e-5, 0.3, 'hyperbolic')],
                   0.0, 8e-6, 2e9, 'auto'),
        'multitone_drag': ([wt.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9,
                                        delta=3e6, block_freq=bf, phase=0.1),
                            wt.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9,
                                         delta=3e6, block_freq=bf, phase=0.1,
                                         tab=0.5)],
                           -5e-9, 40e-9, 2e9, 'auto'),
        'multi_bucket': ([stack, stack >> 1e-7], 0.0, 8.192e-6, 2e9, 4096),
    }


def _lowered(case):
    chans, start, stop, fs, bs = _cases()[case]
    return lower_schedule(chans, start, stop, fs, bucket_samples=bs)


@pytest.mark.parametrize('case', list(_cases()))
def test_dense_kernel_matches_plain(card, case):
    low = _lowered(case)
    n = kernels.synth_dense.launches
    got = synthesize_device(DeviceSchedule(low, card))
    torch.cuda.synchronize()
    assert kernels.synth_dense.launches == n + 1
    plain = synthesize_device(DeviceSchedule(low, 'cpu'))
    assert rel(got.cpu(), plain) <= TOL


@pytest.mark.parametrize('case', list(_cases()))
def test_panel_kernel_matches_plain(card, case):
    low = _lowered(case)
    plan = build_panel_plan(low)
    n = kernels.synth_panel.launches
    got = synthesize_panels(DeviceSchedule(low, card), plan=plan)
    torch.cuda.synchronize()
    assert kernels.synth_panel.launches == n + 1
    plain = synthesize_panels(DeviceSchedule(low, 'cpu'), plan=plan)
    assert rel(got.cpu(), plain) <= TOL


def test_exotic_chirp_opcodes(card):
    """OP_EXPCHIRP/OP_HYPCHIRP set directly into the descriptors (the
    lowering rewrites such chirps before they reach a sampled segment)."""
    low = lower_schedule([wt.gaussian(1e-6)] * 2, -1e-6, 1e-6, 1e9)
    for c, op in enumerate((OP_EXPCHIRP, OP_HYPCHIRP)):
        low.op[c, 0, 0, 0, 0] = op
        low.args[c, 0, 0, 0, 0, 1:4] = (2 * np.pi * 0.1, 1e-3, 0.3)
    got = synthesize_device(DeviceSchedule(low, card)).cpu()
    plain = synthesize_device(DeviceSchedule(low, 'cpu'))
    assert torch.isfinite(got).all()
    assert rel(got, plain) <= TOL


@pytest.mark.parametrize('route', ['dense', 'panel'])
def test_int16_codes_quantize_the_kernels_f32(card, route):
    low = _lowered('shapes')
    scales = np.linspace(16000.0, 32767.0, low.shape[0]).astype(np.float32)
    dev = DeviceSchedule(low, card)
    if route == 'dense':
        f32 = synthesize_device(dev)
        codes = synthesize_device(dev, out_dtype=torch.int16,
                                  dac_scale=scales)
    else:
        plan = build_panel_plan(low)
        f32 = synthesize_panels(dev, plan=plan)
        codes = synthesize_panels(dev, plan=plan, out_dtype=torch.int16,
                                  dac_scale=scales)
    sc = torch.as_tensor(scales, device=card)[:, None]
    expected = torch.clamp(torch.round(f32 * sc), -32768, 32767)
    assert codes.dtype == torch.int16
    assert torch.equal(codes, expected.to(torch.int16))


def test_slice_goes_through_the_kernels(card):
    chans, start, stop, fs, _ = _cases()['mixing_drag']
    kernels.reset_launch_counts()
    got = wt.synthesize(chans, start, stop, fs, device='cuda')
    dense = wt.synthesize(chans, start, stop, fs, device='cuda',
                          engine='cuda-dense')
    panel = wt.synthesize(chans, start, stop, fs, device='cuda',
                          engine='cuda-panel')
    # the card's rule (ops.routes.CARD_RULE) takes K1 for this schedule;
    # engine 'cuda-panel' takes K2
    assert kernels.launch_counts() == {'synth_dense': 2, 'synth_panel': 1,
                                       'synth_sparse': 0, 'synth_stack': 0,
                                       'synth_stack_seq': 0,
                                       'synth_dense_hi': 0,
                                       'synth_panel_hi': 0,
                                       'probe_health': 0, 'probe_grid': 0,
                                       'probe_walker': 0,
                                       'probe_sparse_compact': 0,
                                       'iir_df2t': 0, 'trace_eval': 0}
    plain = wt.synthesize(chans, start, stop, fs, device='cpu')
    assert rel(got.cpu(), plain) <= TOL
    assert rel(dense.cpu(), plain) <= TOL
    assert rel(panel.cpu(), plain) <= TOL


def test_wrapper_refuses_mixed_devices(card):
    low = _lowered('shapes')
    dev = DeviceSchedule(low, 'cpu')
    out = torch.empty((low.shape[0], low.n_samples), device=card)
    with pytest.raises(ValueError, match='expected cuda'):
        kernels.synth_dense(dev, out, None)
    with pytest.raises(ValueError, match='shape'):
        kernels.synth_dense(DeviceSchedule(low, card), out[:, 1:], None)


def _stack_cases():
    """Stack-route schedules (tests/test_stack_synth.py's shapes, cut to
    a few channels): pure vstack, narrow pulses over a wide carrier (K1
    residual), a clipped channel, multi-tone DRAG (ext), several buckets."""
    rng = np.random.default_rng(5)
    vstack = wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                            for o in rng.uniform(0, 7e-6, 150)])
    carrier = 0.1 * wt.cos(2 * np.pi * 150e6) + 0.05
    for _ in range(30):
        carrier += 0.4 * (wt.cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    pulses = wt.zero()
    for _ in range(80):
        pulses += 0.3 * (wt.cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    ds = wt.zero()
    p = wt.drag_sin(5e9, 20e-9, plateau=10e-9, delta=1e6)
    for _ in range(70):
        ds += p >> rng.uniform(0, 7e-6)
    return {
        'vstack': ([vstack, vstack >> 1e-7], 'auto'),
        'mixed_wide': ([carrier, wt.gaussian(7e-6) >> 3.5e-6], 'auto'),
        'clipped': ([wt.cut(2.0 * (wt.gaussian(2e-6) >> 4e-6), max=1.2),
                     pulses], 'auto'),
        'multitone_drag': ([ds], 'auto'),
        'bucketed': ([vstack], 4096),
    }


def _stack_lowered(case):
    chans, bs = _stack_cases()[case]
    low = lower_schedule(chans, 0.0, 8.192e-6, 2e9, bucket_samples=bs)
    return low, build_stack_plan(low)


@pytest.mark.parametrize('case', list(_stack_cases()))
def test_stack_kernel_matches_plain(card, case):
    low, plan = _stack_lowered(case)
    assert plan is not None
    n = kernels.synth_stack.launches
    got = synthesize_stack(low, plan, device=card)
    torch.cuda.synchronize()
    assert kernels.synth_stack.launches == n + 1
    plain = synthesize_stack(low, plan, device='cpu')
    assert rel(got.cpu(), plain) <= TOL


@pytest.mark.parametrize('case', ['vstack', 'mixed_wide'])
def test_stack_int16_in_kernel_and_epilogue(card, case):
    """Without a residual the kernel stores the codes itself; with one the
    f32 sum is quantized after it.  Codes equal the kernel's own f32 output
    quantized, and are within one code of the plain version's."""
    low, plan = _stack_lowered(case)
    assert (plan.wide is None) == (case == 'vstack')
    f32 = synthesize_stack(low, plan, device=card)
    codes = synthesize_stack(low, plan, out_dtype=torch.int16,
                             dac_scale=30000.0, device=card)
    expected = torch.clamp(torch.round(f32 * 30000.0), -32768, 32767)
    assert codes.dtype == torch.int16
    assert torch.equal(codes, expected.to(torch.int16))
    plain = synthesize_stack(low, plan, out_dtype=torch.int16,
                             dac_scale=30000.0, device='cpu')
    assert (codes.cpu().int() - plain.int()).abs().max() <= 1


@pytest.mark.parametrize('case', list(_cases()))
def test_sparse_kernel_matches_plain(card, case):
    low = _lowered(case)
    plan = build_sparse_plan(low)
    n = kernels.synth_sparse.launches
    got = synthesize_sparse(DeviceSchedule(low, card), plan=plan)
    torch.cuda.synchronize()
    assert kernels.synth_sparse.launches == n + 1
    plain = synthesize_sparse(DeviceSchedule(low, 'cpu'), plan=plan)
    assert rel(got.cpu(), plain) <= TOL
    codes = synthesize_sparse(DeviceSchedule(low, card), plan=plan,
                              out_dtype=torch.int16, dac_scale=30000.0)
    expected = torch.clamp(torch.round(got * 30000.0), -32768, 32767)
    assert torch.equal(codes, expected.to(torch.int16))


def _pair_lowered():
    rng = np.random.default_rng(3)
    chans = []
    for c in range(4):
        x = wt.zero()
        for _ in range(6):
            x += ((0.3 + 0.4j) * wt.gaussian(3e-8)
                  * wt.cos(2 * np.pi * (5e7 + 1e6 * c))
                  >> float(rng.uniform(1e-7, 8e-6)))
        chans.append(x)
    return [lower_schedule(chans, 0.0, 8.192e-6, 2e9, part='complex',
                           bucket_samples=bs) for bs in ('auto', 4096)]


@pytest.mark.parametrize('route', ['dense', 'panel', 'sparse'])
@pytest.mark.parametrize('bucketed', [False, True])
def test_pair_mode_matches_plain(card, route, bucketed):
    low = _pair_lowered()[bucketed]
    assert low.amp_im is not None and (low.n_buckets > 1) == bucketed

    def run(device):
        dev = DeviceSchedule(low, device)
        if route == 'dense':
            return synthesize_device(dev)
        if route == 'panel':
            return synthesize_panels(dev, plan=build_panel_plan(low))
        return synthesize_sparse(dev, plan=build_sparse_plan(low))

    got = run(card)
    assert got.dtype == torch.complex64
    plain = run('cpu')
    for part in (torch.real, torch.imag):
        assert rel(part(got).cpu(), part(plain)) <= TOL


TOL_HI = 1e-12


def _hi_cases():
    """Double-tier schedules at 2 GS/s: (channels, start, stop,
    bucket_samples)."""
    rng = np.random.default_rng(4)
    pulses = []
    for c in range(3):
        x = wt.zero()
        for _ in range(4):
            x += ((wt.gaussian(3e-8) >> float(rng.uniform(0, 7e-6)))
                  * wt.cos(2 * np.pi * (1e8 + 1e6 * c), 0.3))
        pulses.append(x)
    clipped = (2.0 * wt.gaussian(2e-6)) >> 4e-6
    clipped.min, clipped.max = -1.0, 1.0
    stack = wt.WaveVStack([(0.3 * wt.cosPulse(40e-9) >> o)
                           for o in rng.uniform(0, 7e-6, 60)])
    bf = (151e6, -83e6, 217e6)
    return {
        'pulses': (pulses, 0.0, 8.192e-6, 'auto'),
        'shapes': ([wt.square(2e-6, edge=1e-7, type='erf') >> 3e-6,
                    wt.sinc(8e6) >> 4e-6, wt.gaussian(6e-7, d=2) >> 3e-6,
                    wt.mollifier(2e-6, d=3) >> 3e-6,
                    (wt.sinh(2e6) * wt.gaussian(1e-6)) >> 3e-6,
                    (wt.square(2e-6) * wt.cosh(1e6) ** -1) >> 3e-6,
                    (wt.exp(-2e6) >> 1e-6) * wt.square(3e-6) >> 2e-6,
                    clipped], 0.0, 8.192e-6, 'auto'),
        'drag_chirp': ([wt.drag(50e6, 100e-9, plateau=40e-9, delta=1e6,
                                block_freq=None, phase=0.3) >> 2e-6,
                        wt.chirp(1e6, 50e6, 1e-5, 0.3, 'linear'),
                        wt.chirp(1e6, 8e7, 8.192e-6, type='exponential')
                        * wt.gaussian(4e-6) >> 4e-6],
                       0.0, 8.192e-6, None),
        'multitone_drag': ([wt.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9,
                                        delta=3e6, block_freq=bf, phase=0.1),
                            wt.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9,
                                         delta=3e6, block_freq=bf, phase=0.1,
                                         tab=0.5)],
                           -5e-9, 40e-9, 'auto'),
        'bucketed': ([stack, stack >> 1e-7], 0.0, 8.192e-6, 4096),
    }


def _hi_lowered(case):
    chans, start, stop, bs = _hi_cases()[case]
    return lower_schedule(chans, start, stop, 2e9, bucket_samples=bs,
                          keep_f64=True)


@pytest.mark.parametrize('case', list(_hi_cases()))
def test_hi_dense_kernel_matches_plain(card, case):
    low = _hi_lowered(case)
    n = kernels.synth_dense_hi.launches
    got = synthesize_hi(HiSchedule(low, card))
    torch.cuda.synchronize()
    assert kernels.synth_dense_hi.launches == n + 1
    assert got.dtype == torch.float64
    plain = synthesize_hi(HiSchedule(low, 'cpu'))
    assert rel(got.cpu(), plain) <= TOL_HI


@pytest.mark.parametrize('case', [c for c in _hi_cases() if c != 'bucketed'])
def test_hi_panel_kernel_matches_plain(card, case):
    low = _hi_lowered(case)
    plan = build_panel_plan(low)
    n = kernels.synth_panel_hi.launches
    got = synthesize_hi_panels(HiSchedule(low, card), plan=plan)
    torch.cuda.synchronize()
    assert kernels.synth_panel_hi.launches == n + 1
    plain = synthesize_hi_panels(HiSchedule(low, 'cpu'), plan=plan)
    assert rel(got.cpu(), plain) <= TOL_HI


@pytest.mark.parametrize('route', ['dense', 'panel'])
def test_hi_split_planes(card, route):
    """combine=False on the card: hi == f32(out), and hi + lo within 1e-14
    of the peak of the f64 output."""
    low = _hi_lowered('pulses')
    dev = HiSchedule(low, card)
    if route == 'dense':
        out = synthesize_hi(dev)
        hi, lo = synthesize_hi(dev, combine=False)
    else:
        plan = build_panel_plan(low)
        out = synthesize_hi_panels(dev, plan=plan)
        hi, lo = synthesize_hi_panels(dev, plan=plan, combine=False)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, out.float())
    assert ((hi.double() + lo.double() - out).abs().max()
            <= 1e-14 * out.abs().max())


def test_double_slice_goes_through_the_hi_kernels(card):
    chans, start, stop, _ = _hi_cases()['pulses']
    kernels.reset_launch_counts()
    got = wt.synthesize(chans, start, stop, 2e9, precision='double',
                        device='cuda')
    dense = wt.synthesize(chans, start, stop, 2e9, precision='double',
                          engine='cuda-dense', device='cuda')
    # no engine of synthesize takes K4 on the card: its panels directly
    low = _hi_lowered('pulses')
    panel = synthesize_hi_panels(HiSchedule(low, card),
                                 plan=build_panel_plan(low))
    counts = kernels.launch_counts()
    # the card's rule (ops.routes.CARD_RULE) takes K3 for the double tier
    assert counts['synth_panel_hi'] == 1 and counts['synth_dense_hi'] == 2
    assert sum(counts.values()) == 3
    assert got.dtype == dense.dtype == panel.dtype == torch.float64
    plain = wt.synthesize(chans, start, stop, 2e9, precision='double',
                          device='cpu')
    assert rel(got.cpu(), plain) <= TOL_HI
    assert rel(dense.cpu(), plain) <= TOL_HI
    assert rel(panel.cpu(), synthesize_hi_panels(
        HiSchedule(low, 'cpu'), plan=build_panel_plan(low))) <= TOL_HI


def _seq_table(n_schedules=3, n_channels=2, seed=13):
    """A table of narrow-pulse schedules: pulse trains of cosPulses and
    DRAG-mixed gaussians (the panel, worklist and stack paths take it)."""
    rng = np.random.default_rng(seed)
    lows = []
    for _ in range(n_schedules):
        chans = []
        for c in range(n_channels):
            x = wt.zero()
            for o in rng.uniform(0, 7.5e-6, 12):
                I, _ = wt.mixing(0.4 * wt.cosPulse(40e-9) >> float(o),
                                 freq=-120e6 - 3e6 * c, DRAGScaling=1e-10)
                x += I
            chans.append(x)
        lows.append(lower_schedule(chans, 0.0, 8.192e-6, 2e9,
                                   bucket_samples=None))
    return lows


KS = [2, 0, 99, -3, 1]


def test_stack_seq_kernel_matches_plain(card):
    """K6 on the card against its plain version: f32 within TOL, int16
    equal to the kernel's own f32 quantized; out-of-range ks clamp."""
    from waveforms_tpu_torch.ops import StackSequencer
    lows = _seq_table()
    seq = StackSequencer(lows, device=card)
    n = kernels.synth_stack_seq.launches
    got = seq.play_packed(KS)
    torch.cuda.synchronize()
    assert kernels.synth_stack_seq.launches == n + 1
    plain = StackSequencer(lows, device='cpu').play_packed(KS)
    assert rel(got.cpu(), plain) <= TOL
    assert torch.equal(got[2], got[0]) and torch.equal(got[3], seq.play(0))
    codes = seq.play_packed(KS, out_dtype=torch.int16, dac_scale=30000.0)
    expected = torch.clamp(torch.round(got * 30000.0), -32768, 32767)
    assert torch.equal(codes, expected.to(torch.int16))
    # ks computed on the card: the kernel reads it there
    ks_dev = torch.tensor(KS, device=card)
    assert torch.equal(seq.play_packed(ks_dev), got)


@pytest.mark.parametrize('method,dtype', [
    (m, d) for m in ('play', 'play_many', 'play_sparse', 'play_packed',
                     'play_replay')
    for d in (torch.float32, torch.int16)
    if (m, d) != ('play_sparse', torch.int16)])     # f32-only, as in JAX
def test_sequencer_on_card_matches_plain(card, method, dtype):
    """Each Sequencer method on the card (K1, K7, K2) against the same
    method on the CPU (the plain versions); int16 within one code."""
    from waveforms_tpu_torch.ops import Sequencer
    lows = _seq_table()
    kern = {'play': kernels.synth_dense, 'play_many': kernels.synth_dense,
            'play_sparse': kernels.synth_sparse,
            'play_packed': kernels.synth_panel,
            'play_replay': kernels.synth_dense}[method]

    def run(device):
        seq = Sequencer(lows, device=device)
        kw = {} if dtype == torch.float32 else {'out_dtype': dtype,
                                                'dac_scale': 30000.0}
        if method in ('play', 'play_sparse'):
            return torch.stack([getattr(seq, method)(k, **kw) for k in KS])
        return getattr(seq, method)(KS, **kw)
    n = kern.launches
    got = run(card)
    torch.cuda.synchronize()
    assert kern.launches > n
    plain = run('cpu')
    assert got.dtype == plain.dtype == dtype
    assert tuple(got.shape) == (len(KS), 2, lows[0].n_samples)
    if dtype == torch.float32:
        assert rel(got.cpu(), plain) <= TOL
    else:
        assert (got.cpu().int() - plain.int()).abs().max() <= 1


def _shot_table(mode):
    """A table for the shot entries: _seq_table's pulse trains, a pair-mode
    table of two schedules, or ('wide') two occupancy-1 schedules of 128
    channels x 131,072 samples, a grid wide enough for K1's layout of 8
    samples a thread."""
    if mode == 'complex64':
        rng = np.random.default_rng(3)
        lows = []
        for _ in range(2):
            chans = []
            for c in range(4):
                x = wt.zero()
                for _ in range(6):
                    x += ((0.3 + 0.4j) * wt.gaussian(3e-8)
                          * wt.cos(2 * np.pi * (5e7 + 1e6 * c))
                          >> float(rng.uniform(1e-7, 8e-6)))
                chans.append(x)
            lows.append(lower_schedule(chans, 0.0, 8.192e-6, 2e9,
                                       part='complex', bucket_samples=None))
        return lows
    if mode == 'wide':
        return [lower_schedule(build_dense_schedule(128, d), 0.0, 65.536e-6,
                               2e9, bucket_samples=None)
                for d in (65.536e-6, 32.768e-6)]
    return _seq_table()


@pytest.mark.parametrize('mode', ['float32', 'int16', 'bfloat16', 'float16',
                                  'complex64', 'wide', 'sparse'])
def test_shot_entries_match_one_shot_launches_and_plain(card, mode):
    """K1's shot entry (K7's with 'sparse') plays the shot vector KS, with
    indices past both ends, in one launch; each shot is bit-identical to a
    one-shot launch of its clamped schedule, and the whole is held to the
    shot entry's plain version on the same tensors: f32 and complex64
    within TOL, int16 within one code, bf16 and f16 equal to the kernel's
    own f32 output rounded once."""
    from waveforms_tpu_torch.ops import Sequencer
    seq = Sequencer(_shot_table(mode), device=card)
    C, N = seq.shape[0], seq.n_samples
    dt = {'int16': torch.int16, 'bfloat16': torch.bfloat16,
          'float16': torch.float16,
          'complex64': torch.complex64}.get(mode, torch.float32)
    scale = (torch.full((C,), 30000.0, device=card) if mode == 'int16'
             else None)
    kern = kernels.synth_sparse if mode == 'sparse' else kernels.synth_dense
    n = (kern.launches, kern.shot_launches)
    if mode == 'sparse':
        got = seq.play_many(KS, sparse=True, Rs=8)
    elif dt in (torch.float32, torch.complex64):
        got = seq.play_many(KS)
    else:
        got = seq.play_many(KS, out_dtype=dt, dac_scale=30000.0)
    torch.cuda.synchronize()
    assert (kern.launches, kern.shot_launches) == (n[0] + 1, n[1] + 1)
    assert got.dtype == dt and tuple(got.shape) == (len(KS), C, N)
    for s, k in enumerate(KS):
        k = seq._clamp(k)
        if mode == 'sparse':
            one = kernels.synth_sparse(*seq._sparse_args(k, 8),
                                       torch.zeros_like(got[s]), None)
        else:
            one = kernels.synth_dense(seq._schedule(k),
                                      torch.empty_like(got[s]), scale)
        assert torch.equal(got[s], one), (s, k)
    ks = seq.shot_indices(KS)
    if mode == 'sparse':
        plain = kernels.synth_sparse.plain_shots(
            seq, seq._stacked_work(8), ks, torch.zeros_like(got), None)
    else:
        plain = kernels.synth_dense.plain_shots(seq, ks,
                                                torch.empty_like(got), scale)
    if dt in (torch.bfloat16, torch.float16):
        assert torch.equal(got, seq.play_many(KS).to(dt))
    elif dt == torch.int16:
        assert (got.int() - plain.int()).abs().max() <= 1
    else:
        a, b = got.cpu().numpy(), plain.cpu().numpy()
        if dt == torch.complex64:
            a, b = np.abs(a - b), np.abs(b)
            assert float((a.max(-1) / np.maximum(b.max(-1), 1e-30)).max()) \
                <= TOL
        else:
            assert rel(a, b) <= TOL


def test_card_computed_shot_vector_plays_with_no_host_sync(card):
    """A shot vector drawn on the card (int64 and int32, indices past both
    ends) plays through K1's and K7's shot entries under
    ``torch.cuda.set_sync_debug_mode('error')``: no host sync, the index
    never read on the host; the shots equal a play of the same indices
    read back afterwards."""
    from waveforms_tpu_torch.ops import Sequencer
    seq = Sequencer(_seq_table(), device=card)
    seq.play_many([0], sparse=True, Rs=8)     # builds the worklists
    gen = torch.Generator(card).manual_seed(5)
    ks = torch.randint(-2, 6, (7,), device=card, generator=gen)
    ks32 = ks.to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        dense = seq.play_many(ks)
        dense32 = seq.play_many(ks32)
        narrow = seq.play_many(ks32, out_dtype=torch.bfloat16)
        sparse = seq.play_many(ks, sparse=True, Rs=8)
        one = seq.play(ks[3])
        one_sparse = seq.play_sparse(ks32[3], Rs=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = ks.cpu().tolist()
    want = seq.play_many(host)
    assert torch.equal(dense, want) and torch.equal(dense32, want)
    assert torch.equal(narrow, want.to(torch.bfloat16))
    assert torch.equal(sparse, seq.play_many(host, sparse=True, Rs=8))
    assert torch.equal(one, want[3]) and torch.equal(one_sparse, sparse[3])


@pytest.mark.parametrize('dtype', [torch.int32, torch.int64])
def test_play_replay_clamps_a_card_index(card, dtype):
    """``play_replay`` gathers its palette rows with ``index_select``,
    which clamps nothing: a card-held index past both ends of the table
    (int32 as the shot entries take it, and int64) is clamped on the card
    without a host sync and gives the rows of the same call with host
    indices."""
    from waveforms_tpu_torch.ops import Sequencer
    seq = Sequencer(_seq_table(), device=card)
    host = [-1, 3, 2, 1 << 20, 0, -(1 << 20)]
    want = seq.play_replay(host)              # builds the palette
    ks = torch.tensor(host, dtype=dtype, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = seq.play_replay(ks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert torch.equal(want, seq.play_many([0, 2, 2, 2, 0, 0]))


@pytest.mark.parametrize('chain', ['signals', 'filtered', 'iq'])
def test_run_sequence_graph_equals_the_host_loop(card, chain):
    """``run_sequence`` on the card (one captured graph a shot, the order a
    CUDA tensor) against its plain version, the host loop, bit for bit; the
    Python counters see the eager shot 0 and the capture, and a second run
    of one SequenceGraph replays every shot again to the same bits."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import (SequenceGraph, run_sequence,
                                              run_sequence_loop)
    seq = Sequencer(_seq_table(n_schedules=4), device=card)
    kw = {}
    if chain != 'signals':
        kw['ba_filters'] = [exp_decay_filter(a, t, 2e9, inv=True)
                            for a, t in ((0.02, 3e-6), (0.005, 20e-6))]
    if chain == 'iq':
        kw['demod_freqs'] = [-121.64e6, -67.52e6]
    order = torch.tensor([3, 0, 9, -1, 2, 1, 1], device=card)
    n = (kernels.synth_dense.launches, kernels.iir_df2t.launches)
    got = run_sequence(seq, order, **kw)
    torch.cuda.synchronize()
    assert (kernels.synth_dense.launches - n[0],
            kernels.iir_df2t.launches - n[1]) == (
        2, 0 if chain == 'signals' else 2)
    want = run_sequence_loop(seq, order.cpu().tolist(), **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    graph = SequenceGraph(seq, order, **kw)
    assert torch.equal(graph.run().clone(), want)
    assert torch.equal(graph.run(), want)


@pytest.mark.parametrize('chain', ['signals', 'filtered', 'iq'])
def test_run_sequence_keeps_its_graph_across_calls(card, chain):
    """Three ``run_sequence`` calls with other index vectors (a card
    tensor, a host list, a card tensor of int32) and one key: one capture
    among them (``graph_misses`` 1, the Python counters see only the
    first call's eager shot and capture), each result bit-equal to the
    host loop, and the first call's tensor unchanged by the later ones."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import run_sequence, run_sequence_loop
    seq = Sequencer(_seq_table(n_schedules=4), device=card)

    def kw():
        out = {}
        if chain != 'signals':
            out['ba_filters'] = [exp_decay_filter(a, t, 2e9, inv=True)
                                 for a, t in ((0.02, 3e-6), (0.005, 20e-6))]
        if chain == 'iq':
            out['demod_freqs'] = [-121.64e6, -67.52e6]
        return out
    orders = [[3, 0, 9, -1, 2, 1, 1], [0, 0, 1, 2, 3, 3, 1],
              [2, 3, 1, 0, 0, -5, 2]]
    given = [torch.tensor(orders[0], device=card), orders[1],
             torch.tensor(orders[2], device=card, dtype=torch.int32)]
    n = (kernels.synth_dense.launches, kernels.iir_df2t.launches)
    got = [run_sequence(seq, ks, **kw()) for ks in given]
    torch.cuda.synchronize()
    first = got[0].clone()
    assert (seq.graph_misses, seq.graph_hits) == (1, 2)
    assert (kernels.synth_dense.launches - n[0],
            kernels.iir_df2t.launches - n[1]) == (
        2, 0 if chain == 'signals' else 2)
    for order, out in zip(orders, got):
        want = run_sequence_loop(seq, order, **kw())
        assert out.dtype == want.dtype and torch.equal(out, want)
    assert torch.equal(got[0], first)


def test_a_kept_graph_on_a_second_stream_follows_the_first_call(card):
    """The first call queued behind a long spin on the current stream, the
    second (a hit) issued at once on another stream: the second waits for
    the first, so each call's result is its own indices' (bit-equal to the
    host loop) and the first's is not overwritten."""
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import run_sequence, run_sequence_loop
    seq = Sequencer(_seq_table(n_schedules=4), device=card)
    kw = {'demod_freqs': [-121.64e6, -67.52e6]}
    orders = [[3, 0, 2, 1, 1], [0, 2, 2, 3, 0]]
    ks = [torch.tensor(order, device=card) for order in orders]
    other = torch.cuda.Stream(card)
    run_sequence(seq, orders[1], **kw)               # capture
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)                   # ~0.1 s on the card
    first = run_sequence(seq, ks[0], **kw)
    with torch.cuda.stream(other):
        second = run_sequence(seq, ks[1], **kw)
    torch.cuda.synchronize()
    assert (seq.graph_misses, seq.graph_hits) == (1, 2)
    assert torch.equal(first, run_sequence_loop(seq, orders[0], **kw))
    assert torch.equal(second, run_sequence_loop(seq, orders[1], **kw))


def test_run_sequence_of_one_shot_is_not_captured(card):
    """A single shot is ``SequenceGraph``'s eager shot 0: nothing is
    captured (no graph, and under a profiler no ``wf.sequence.capture``
    span), and the result equals the host loop's, on every run."""
    from torch.profiler import ProfilerActivity, profile

    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import SequenceGraph, run_sequence_loop
    from waveforms_tpu_torch.utils.profiling import span_record
    seq = Sequencer(_seq_table(n_schedules=4), device=card)
    kw = {'demod_freqs': [-121.64e6, -67.52e6]}
    order = torch.tensor([7], device=card)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        graph = SequenceGraph(seq, order, **kw)
    rec = span_record()
    spans = [n for n, s in zip(rec.names, rec.starts) if s >= t0]
    assert graph.graph is None and 'wf.sequence.capture' not in spans
    assert 'wf.sequence.eager_shot' in spans
    want = run_sequence_loop(seq, [3], **kw)
    assert torch.equal(graph.run(), want) and torch.equal(graph.run(), want)


def test_run_sequence_spans_cover_the_call(card, tmp_path, monkeypatch):
    """A traced ``run_sequence`` of 7 shots, twice: the first call
    captures (its key new), in one ``wf.sequence.capture``, which holds
    the whole of ``torch.cuda.graph``'s entry and exit (its synchronize
    and cache emptying) and so lasts at least the stretch from inside the
    entry to the instantiated graph; the second reuses the kept graph, in
    one ``wf.sequence.reuse`` and no capture; and every device operation
    launched inside a call is launched under a ``wf.*`` span -- all but
    the replays' under a span other than ``wf.sequence.replay``."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.parallel import run_sequence
    from waveforms_tpu_torch.utils import profiling
    seq = Sequencer(_seq_table(n_schedules=4), device=card)
    kw = {'ba_filters': [exp_decay_filter(0.02, 3e-6, 2e9, inv=True)],
          'demod_freqs': [-121.64e6, -67.52e6]}
    order = torch.tensor([3, 0, 9, -1, 2, 1, 1], device=card)
    run_sequence(seq, order[:6], **kw)         # builds the kernels
    torch.cuda.synchronize()

    graphs = []
    real = torch.cuda.graph

    class timed(real):
        """torch.cuda.graph, with the host's clock before its entry,
        inside it, and after its exit."""
        def __enter__(self):
            graphs.append([time.perf_counter()])
            out = super().__enter__()
            graphs[-1].append(time.perf_counter())
            return out

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            graphs[-1].append(time.perf_counter())
            return out

    monkeypatch.setattr(torch.cuda, 'graph', timed)
    t0 = time.perf_counter()
    calls = []
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            a = time.perf_counter()
            with torch.profiler.record_function('test.call'):
                run_sequence(seq, order, **kw)
            calls.append((a, time.perf_counter()))
    rec = profiling.span_record()
    captures = [(s, e) for n, s, e in zip(rec.names, rec.starts, rec.ends)
                if n == 'wf.sequence.capture' and s >= t0]
    reuses = [s for n, s in zip(rec.names, rec.starts)
              if n == 'wf.sequence.reuse' and s >= t0]
    assert len(captures) == len(graphs) == 1
    (a, b), (s, e), (before, inside, after) = calls[0], captures[0], graphs[0]
    assert a <= s <= before and after <= e <= b
    assert e - s >= after - inside
    assert len(reuses) == 1 and calls[1][0] <= reuses[0] <= calls[1][1]
    # the trace: each device operation launched inside a call (its launch,
    # the runtime call with its correlation id) is launched under a wf.*
    # range
    cats = profiling.KERNELS + profiling.COPIES

    def ops(pattern):
        return {(e['ts'], e['name'], (e.get('args') or {}).get('correlation'))
                for e in profiling.launched_under(str(tmp_path), pattern,
                                                  cats)}
    in_calls = ops('test.call')
    replayed = in_calls & ops('wf.sequence.replay')
    assert in_calls <= ops('wf.*')
    assert len(in_calls) > len(replayed) > 0


def test_probe_health_kernel_doubles(card):
    x = torch.linspace(-3, 3, 8 * 128, device=card).reshape(8, 128)
    n = kernels.probe_health.launches
    y = kernels.probe_health(x, torch.empty_like(x))
    torch.cuda.synchronize()
    assert kernels.probe_health.launches == n + 1
    assert torch.equal(y, x * 2)
    assert probes.health_probe(card)['ok']


@pytest.mark.parametrize('variant', list(probes.GRID_VARIANTS))
def test_probe_grid_kernel_matches_plain_exactly(card, variant):
    """P2 at K = 64 (the dynamic output map: 64 steps into 256 blocks,
    the rest left zero) equals its plain version bit for bit."""
    inp = probes.grid_inputs(64, card)
    got = probes.run_grid(variant, inp, probes.grid_out(variant, inp))
    plain = probes.run_grid(variant, inp, probes.grid_out(variant, inp),
                            kernels.probe_grid.plain)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)


@pytest.mark.parametrize('body', [b for b, _ in WALKER_BODIES])
def test_probe_walker_kernel_matches_plain_exactly(card, body):
    inp = probes.walker_inputs(64, card)
    out = torch.zeros((64, 32, 128), device=card)
    got = probes.run_walker(body, inp, out)
    plain = probes.run_walker(body, inp, torch.zeros_like(out),
                              kernels.probe_walker.plain)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)


def test_probe_sparse_compact_matches_plain(card):
    """P1's compact kernel against its plain version within 1e-6 of each
    channel's peak, on the worklist and on the worklist padded 4x (padding
    items store zeros)."""
    inp = probes.sparse_inputs(8, 32.768e-6, card)
    dev, work, padded = inp['dev'], inp['work'], inp['padded']
    K = work.work_c.shape[0]
    peak = kernels.synth_sparse.plain(
        dev, work, torch.zeros((8, inp['plan'].window_samples), device=card),
        None).abs().amax(dim=1).clamp_min(1e-30)
    for w in (work, padded):
        n = w.work_c.shape[0]
        got = kernels.probe_sparse_compact(
            dev, w, torch.empty((n, 32, 128), device=card))
        plain = kernels.probe_sparse_compact.plain(
            dev, w, torch.empty_like(got))
        err = ((got - plain).abs().reshape(n, -1).amax(dim=1)
               / peak[w.work_c.long()])
        assert float(err.max()) <= TOL
    assert (got[K:] == 0).all()


NARROW = (torch.bfloat16, torch.float16)


def _near_narrow(a, b):
    """a == b, or within one ulp of the narrow type at max(|a|, |b|) plus
    TOL of the channel's finite peak (the f32 contract between kernel and
    plain version, moved through a monotonic rounding)."""
    a, b = a.cpu(), b.cpu()
    big = torch.maximum(a.abs(), b.abs())
    ulp = (big.view(torch.int16) + 1).view(a.dtype).float() - big.float()
    fb = b.float()
    peak = torch.where(torch.isfinite(fb), fb.abs(), 0.0).amax(
        dim=-1, keepdim=True)
    return bool(((a == b) | ((a.float() - fb).abs()
                             <= ulp + TOL * peak)).all())


def _narrow_run(route, device, dtype):
    """One route's output on ``device`` in ``dtype`` (None: f32)."""
    kw = {} if dtype is None else {'out_dtype': dtype}
    if route in ('stack', 'stack_seq'):
        low, plan = _stack_lowered('vstack')
        if route == 'stack':
            return synthesize_stack(low, plan, device=device, **kw)
        from waveforms_tpu_torch.ops import StackSequencer
        return StackSequencer(_seq_table(), device=device).play_packed(
            KS, **kw)
    low = _lowered('mixing_drag')
    dev = DeviceSchedule(low, device)
    if route == 'dense':
        return synthesize_device(dev, **kw)
    if route == 'panel':
        return synthesize_panels(dev, plan=build_panel_plan(low), **kw)
    return synthesize_sparse(dev, plan=build_sparse_plan(low), **kw)


@pytest.mark.parametrize('dtype', NARROW)
@pytest.mark.parametrize('route', ['dense', 'panel', 'sparse', 'stack',
                                   'stack_seq'])
def test_narrowed_stores_round_the_kernels_f32(card, route, dtype):
    """bf16 / f16 stores of K1, K2, K7, K5 and K6: equal to the kernel's
    own f32 output rounded once (torch.equal), and near the plain version's
    narrowed output."""
    got = _narrow_run(route, card, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, _narrow_run(route, card, None).to(dtype))
    assert _near_narrow(got, _narrow_run(route, 'cpu', dtype))


def _walker_cases():
    """The tile walker's corners (K1 and, on HI_OPS, K3): occupancy 1,
    several buckets, segments that cover part of a tile on a channel with
    cmin > 0 (samples outside add nothing, not cmin), a mollifier and a
    1/cosh whose factors are evaluated out of their support, and a pulse
    train with many segments per tile."""
    rng = np.random.default_rng(21)
    clipped = [0.8 * wt.gaussian(30e-9) >> float(o)
               for o in rng.uniform(1e-7, 3.9e-6, 3)]
    for w in clipped:
        w.min, w.max = 0.2, 1.0
    train = wt.zero()
    for o in rng.uniform(0, 4e-6, 40):
        train += 0.3 * wt.cosPulse(10e-9) >> float(o)
    return {
        'occupancy_1': (build_dense_schedule(4, 4.096e-6),
                        4.096e-6, 'auto'),
        'masked_cmin': (clipped, 4.096e-6, 'auto'),
        'out_of_support': ([wt.mollifier(1e-7, d=2) >> 1e-6,
                            (wt.square(2e-7) * wt.cosh(5e7) ** -1) >> 2e-6,
                            wt.gaussian(2e-8) ** 3 >> 3e-6],
                           4.096e-6, 'auto'),
        'many_segments': ([train], 4.096e-6, 'auto'),
        'multi_bucket': ([train, wt.gaussian(1e-6) >> 2e-6], 8.192e-6,
                         2048),
    }


@pytest.mark.parametrize('case', list(_walker_cases()))
def test_tile_walker_matches_plain(card, case):
    chans, stop, bs = _walker_cases()[case]
    low = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs)
    got = synthesize_device(DeviceSchedule(low, card)).cpu()
    plain = synthesize_device(DeviceSchedule(low, 'cpu'))
    assert torch.isfinite(got).all()
    assert rel(got, plain) <= TOL
    if case == 'masked_cmin':
        assert (got[plain == 0] == 0).all() and (plain == 0).any()
    hi = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs,
                        keep_f64=True)
    got = synthesize_hi(HiSchedule(hi, card)).cpu()
    plain = synthesize_hi(HiSchedule(hi, 'cpu'))
    assert torch.isfinite(got).all()
    assert rel(got, plain) <= TOL_HI


def _every_opcode_lowered():
    """Every opcode of op_builders, each as the only factor of a channel:
    the lowering's own, and OP_EXPCHIRP, OP_HYPCHIRP and the reserved
    OP_INTERP set directly into a gaussian's descriptors."""
    from waveforms_tpu_torch.ops.lowering import OP_INTERP
    bf = (151e6, -83e6)
    chans = [wt.gaussian(1e-7), wt.square(1e-7, edge=2e-8, type='erf'),
             wt.cos(2 * np.pi * 1e8), wt.sinc(5e7), wt.exp(1e6),
             wt.chirp(1e6, 5e7, 4e-7, 0.3, 'linear'),
             wt.cosh(5e6) * wt.square(2e-7), wt.sinh(5e6) * wt.square(2e-7),
             wt.drag(100e6, 20e-9, plateau=10e-9, delta=2e6,
                     block_freq=250e6, phase=0.4),
             wt.gaussian(1e-7, d=2), wt.mollifier(1e-7, d=1),
             wt.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                         block_freq=bf, phase=0.1),
             wt.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                          block_freq=bf, phase=0.1, tab=0.5),
             wt.poly([0.5, 1e5]) * wt.square(3e-7)]
    chans += [wt.gaussian(1e-7)] * 3
    low = lower_schedule(chans, -2e-7, 2e-7, 2e9)
    for c, op in zip(range(len(chans) - 3, len(chans)),
                     (OP_EXPCHIRP, OP_HYPCHIRP, OP_INTERP)):
        low.op[c, 0, 0, 0, 0] = op
        low.args[c, 0, 0, 0, 0, 1:4] = (2 * np.pi * 0.1, 1e-3, 0.3)
    ops = set(np.unique(low.op[np.arange(low.shape[4])
                               < low.nfac[..., None]]).tolist())
    assert ops == set(range(17))
    return low


def test_tile_walker_every_opcode(card):
    """Every opcode through K1.  cosh and sinh run at a rate where their
    peak is about 1, as in the JAX suite: 0.5 * (e - 1/e) carries about one
    f32 ulp of e absolute, which is 1.2e-6 of a 0.1 peak (sinh(1e6) over
    +-0.2 us)."""
    low = _every_opcode_lowered()
    got = synthesize_device(DeviceSchedule(low, card)).cpu()
    plain = synthesize_device(DeviceSchedule(low, 'cpu'))
    assert torch.isfinite(got).all()
    errs = {c: rel(g[None], p[None])
            for c, (g, p) in enumerate(zip(got, plain))}
    assert max(errs.values()) <= TOL, {c: e for c, e in errs.items()
                                       if e > TOL}


MIN_DENSE_BLOCKS = 1024   # csrc/synth_common.cuh: from here K1 runs 8
                          # samples a thread, under it 4


def _wide(low):
    """(reps, ``low`` with its channels repeated reps times), reps the
    fewest that give K1 a grid of MIN_DENSE_BLOCKS tiles."""
    tiles = -(-low.n_samples // kernels.dense_tile(low)) * low.shape[0]
    reps = -(-MIN_DENSE_BLOCKS // tiles)
    assert tiles < MIN_DENSE_BLOCKS
    return reps, dataclasses.replace(low, **{
        f.name: np.concatenate([v] * reps)
        for f in dataclasses.fields(low)
        if f.name != 'ext' and isinstance(v := getattr(low, f.name),
                                          np.ndarray)})


@pytest.mark.parametrize('case', ['every_opcode', *_walker_cases()])
def test_tile_walker_wide_grid_matches_small(card, case):
    """K1 (and, on HI_OPS, K3) on a grid of at least MIN_DENSE_BLOCKS
    tiles, where K1 runs 8 samples a thread and K3 its whole tiles: every
    repeated channel equals the small grid's launch of the same channel
    (4 samples a thread, smaller tiles) bit for bit, and that one is within
    TOL of the plain version."""
    if case == 'every_opcode':
        low = _every_opcode_lowered()
    else:
        chans, stop, bs = _walker_cases()[case]
        low = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs)
    reps, wide = _wide(low)
    small = synthesize_device(DeviceSchedule(low, card))
    got = synthesize_device(DeviceSchedule(wide, card))
    assert torch.equal(got, small.repeat(reps, 1))
    assert rel(small.cpu(), synthesize_device(DeviceSchedule(low, 'cpu'))
               ) <= TOL
    if case == 'every_opcode':
        return
    hi = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs,
                        keep_f64=True)
    reps, wide = _wide(hi)
    small = synthesize_hi(HiSchedule(hi, card))
    got = synthesize_hi(HiSchedule(wide, card))
    assert torch.equal(got, small.repeat(reps, 1))


def _stack_corner_cases():
    """Corners of the pulse-instance kernels K5 and K6, each with the
    staging path it takes (ops/stack_synth.chunk_staging): a row touched by
    several instances, staged; 150 instances in one thread block, more
    than the staged descriptors hold (read in place); more blocks than the
    staged block list holds (100 overlapping DRAGs in one channel);
    n_samples not a multiple of 4; empty chunks and rows; and every
    opcode."""
    rng = np.random.default_rng(17)
    crowded = wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                             for o in rng.uniform(0, 7e-6, 30)])
    short = wt.WaveVStack([(0.5 * wt.cosPulse(20e-9) >> o)
                           for o in np.sort(rng.uniform(0, 15e-6, 150))])
    # three factors: the table's descriptors take 63 words an instance
    gcc = (wt.gaussian(40e-9) * wt.cos(2 * np.pi * 100e6)
           * wt.cos(2 * np.pi * 37e6, 0.3)) >> 1e-6
    drags = wt.zero()
    for _ in range(100):
        drags += wt.drag(100e6, 300e-9, plateau=200e-9, delta=2e6,
                         block_freq=None, phase=rng.uniform(0, 6),
                         t0=0.0) >> rng.uniform(0, 0.6e-6)
    sparse = wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                            for o in (0.3e-6, 0.31e-6, 21.4e-6, 39.9e-6)])
    return {
        'several_per_row': ([crowded, crowded >> 1e-7], 8.192e-6, 'staged'),
        'descriptors_in_place': ([short, gcc], 16e-6,
                                 'descriptors_in_place'),
        'blocks_in_place': ([drags], 1.1e-6, 'in_place'),
        'odd_length': ([crowded, crowded >> 1e-7], 8.1905e-6, None),
        'empty_chunks': ([sparse, sparse >> 2e-6], 40e-6, 'staged'),
        'every_opcode': (None, None, 'staged'),
    }


def _stack_corner(case, device):
    """(lowering, K5 tables on ``device``) of a corner case, in one bucket
    (as StackSequencer takes it), whose chunks were checked to take the
    case's staging path."""
    from waveforms_tpu_torch.ops.stack_synth import (STAGE_BLOCKS,
                                                     build_stack_tables,
                                                     chunk_staging)
    chans, stop, path = _stack_corner_cases()[case]
    low = (_every_opcode_lowered() if chans is None
           else lower_schedule(chans, 0.0, stop, 2e9,
                               bucket_samples=None))
    plan = build_stack_plan(low)
    assert plan is not None and plan.wide is None
    t = build_stack_tables(plan, low, device)
    st = chunk_staging(t)
    listed = st['blocks'] <= STAGE_BLOCKS
    took = {'staged': st['staged'], 'in_place': ~listed,
            'descriptors_in_place': listed & ~st['staged']}
    if path is not None:
        assert took[path][st['blocks'] > 0].any(), path
    if case == 'empty_chunks':
        assert (st['blocks'] == 0).any()
    if case == 'odd_length':
        assert low.n_samples % 4
    return low, t


def _narrowed(f32, dtype):
    """The stores of f32 sums in ``dtype``: int16 codes at 30000.0 a unit,
    bf16 and f16 rounded once."""
    if dtype == torch.int16:
        return torch.clamp(torch.round(f32 * 30000.0), -32768,
                           32767).to(torch.int16)
    return f32.to(dtype)


@pytest.mark.parametrize('case', list(_stack_corner_cases()))
def test_stack_kernel_corners_match_plain(card, case):
    """K5 on each corner against its plain version within TOL, and its
    int16, bf16 and f16 stores equal to its own f32 sums stored so."""
    low, t = _stack_corner(case, card)
    C, n = low.shape[0], low.n_samples
    got = kernels.synth_stack(t, torch.empty((C, n), device=card), None)
    _, tc = _stack_corner(case, 'cpu')
    plain = kernels.synth_stack.plain(tc, torch.empty((C, n)), None)
    assert torch.isfinite(got).all()
    assert rel(got.cpu(), plain) <= TOL
    i16 = torch.full((C,), 30000.0, device=card)
    for dtype in (torch.int16, torch.bfloat16, torch.float16):
        out = kernels.synth_stack(t, torch.empty((C, n), dtype=dtype,
                                                 device=card),
                                  i16 if dtype == torch.int16 else None)
        assert torch.equal(out, _narrowed(got, dtype)), dtype


@pytest.mark.parametrize('case', list(_stack_corner_cases()))
def test_stack_kernel_wide_grid_matches_small(card, case):
    """K5 on a corner's channels repeated until its grid has 2,112 thread
    blocks (16 per SM of the H100) equals the small grid's launch repeated,
    bit for bit."""
    from waveforms_tpu_torch.ops.stack_synth import build_stack_tables
    low, t = _stack_corner(case, card)
    reps = -(-2112 // (low.shape[0] * t.n_chunks))
    wide = dataclasses.replace(low, **{
        f.name: np.concatenate([v] * reps)
        for f in dataclasses.fields(low)
        if f.name != 'ext' and isinstance(v := getattr(low, f.name),
                                          np.ndarray)})
    tw = build_stack_tables(build_stack_plan(wide), wide, card)
    small = kernels.synth_stack(t, torch.empty(low.shape[0], low.n_samples,
                                               device=card), None)
    got = kernels.synth_stack(tw, torch.empty(wide.shape[0], wide.n_samples,
                                              device=card), None)
    assert torch.equal(got, small.repeat(reps, 1))


@pytest.mark.parametrize('case', list(_stack_corner_cases()))
def test_stack_seq_kernel_corners(card, case):
    """K6 on a table of a corner and the same channels rolled by one: each
    shot equals K5 on its clamped schedule bit for bit (one walk), in f32
    and in the int16, bf16 and f16 stores; f32 within TOL of the plain
    version."""
    from waveforms_tpu_torch.ops import StackSequencer
    from waveforms_tpu_torch.ops.stack_synth import build_stack_tables
    low, _ = _stack_corner(case, card)
    rolled = dataclasses.replace(low, **{
        f.name: np.roll(v, 1, axis=0)
        for f in dataclasses.fields(low)
        if f.name != 'ext' and isinstance(v := getattr(low, f.name),
                                          np.ndarray)})
    lows = [low, rolled]
    seq = StackSequencer(lows, device=card)
    ks = [1, 0, 99, -3, 1]
    got = seq.play_packed(ks)
    C, n = low.shape[0], low.n_samples
    k5 = [kernels.synth_stack(build_stack_tables(build_stack_plan(x), x,
                                                 card),
                              torch.empty((C, n), device=card), None)
          for x in lows]
    want = torch.stack([k5[min(max(k, 0), 1)] for k in ks])
    assert torch.equal(got, want)
    plain = StackSequencer(lows, device='cpu').play_packed(ks)
    assert rel(got.cpu().reshape(-1, n), plain.reshape(-1, n)) <= TOL
    for dtype in (torch.int16, torch.bfloat16, torch.float16):
        kw = {'dac_scale': 30000.0} if dtype == torch.int16 else {}
        assert torch.equal(seq.play_packed(ks, out_dtype=dtype, **kw),
                           _narrowed(want, dtype)), dtype


def test_stack_seq_kernel_1000_shots(card):
    """K6 on 16 schedules of 30 cosPulses for 1000 shots, some past both
    ends of the table: every shot equals K5 on its clamped schedule, bit for
    bit, and the plain version's within TOL."""
    from waveforms_tpu_torch.ops import StackSequencer
    from waveforms_tpu_torch.ops.stack_synth import build_stack_tables
    rng = np.random.default_rng(99)
    lows = [lower_schedule([wt.WaveVStack([
        (float(a) * wt.cosPulse(50e-9) >> o)
        for a, o in zip(rng.uniform(0.2, 1.0, 30),
                        rng.uniform(0, 5.02e-6, 30))])], 0.0, 5.12e-6, 2e9)
        for _ in range(16)]
    ks = np.arange(1000) % 16
    ks[::97], ks[1::89] = -7, 16
    seq = StackSequencer(lows, device=card)
    got = seq.play_packed(torch.as_tensor(ks, device=card))
    n = lows[0].n_samples
    k5 = torch.stack([kernels.synth_stack(
        build_stack_tables(build_stack_plan(x), x, card),
        torch.empty((1, n), device=card), None) for x in lows])
    assert torch.equal(got, k5[np.clip(ks, 0, 15)])
    plain = StackSequencer(lows, device='cpu').play_packed(ks[:64])
    assert rel(got[:64].cpu().reshape(-1, n), plain.reshape(-1, n)) <= TOL


def _live_subtiles(plan):
    """(channel, first sample, samples) of each live item of a sparse plan
    inside its window."""
    tile = plan.Rs * 128
    return [(int(c), int(o) * tile,
             min(tile, plan.window_samples - int(o) * tile))
            for c, o in zip(plan.work_c[:plan.n_live],
                            plan.work_o[:plan.n_live])]


@pytest.mark.parametrize('case', list(_cases()))
def test_sparse_kernel_equals_dense_kernel_on_live_subtiles(card, case):
    """K7 and K1 (``engine='cuda-dense'``) walk each sample with the same
    tile walker (walk_tile), so every live subtile of K7's output equals
    K1's samples there bit for bit, and K7 stores nothing else."""
    low = _lowered(case)
    plan = build_sparse_plan(low)
    got = synthesize_sparse(DeviceSchedule(low, card), plan=plan)
    dense = synthesize_device(DeviceSchedule(low, card))
    live = torch.zeros(got.shape, dtype=torch.bool, device=card)
    for c, s, n in _live_subtiles(plan):
        assert torch.equal(got[c, s:s + n], dense[c, s:s + n]), (c, s)
        live[c, s:s + n] = True
    assert (got[~live] == 0).all()


def _ragged(case, Rs):
    """A case lowered one sample short (3999 or 15,999 samples: not a
    multiple of 128), in buckets of 4 subtiles of Rs rows."""
    chans, start, stop, fs, _ = _cases()[case]
    return lower_schedule(chans, start, stop - 1 / fs, fs,
                          bucket_samples=Rs * 128 * 4)


@pytest.mark.parametrize('Rs', [1, 3, 8, 32])
@pytest.mark.parametrize('case', ['shapes', 'chirps'])
def test_sparse_kernel_subtile_heights(card, case, Rs):
    """K7 at Rs 1, 3, 8 and 32 (passes of 1024 samples: part of one at Rs 1
    and 3, one at 8, four at 32) within TOL of its plain version, its int16
    codes the quantized f32 output, and P1 on the same worklist equal to K7
    on every live subtile bit for bit."""
    low = _ragged(case, Rs)
    plan = build_sparse_plan(low, Rs=Rs)
    assert low.n_samples % (Rs * 128)
    got = synthesize_sparse(DeviceSchedule(low, card), plan=plan)
    plain = synthesize_sparse(DeviceSchedule(low, 'cpu'), plan=plan)
    assert rel(got.cpu(), plain) <= TOL
    codes = synthesize_sparse(DeviceSchedule(low, card), plan=plan,
                              out_dtype=torch.int16, dac_scale=30000.0)
    expected = torch.clamp(torch.round(got * 30000.0), -32768, 32767)
    assert torch.equal(codes, expected.to(torch.int16))
    dev = DeviceSchedule(low, card)
    work = SparseWork.upload(plan, card)
    compact = kernels.probe_sparse_compact(
        dev, work, torch.full((len(plan.work_c), Rs, 128), 7.0,
                              device=card)).reshape(len(plan.work_c), -1)
    for k, (c, s, n) in enumerate(_live_subtiles(plan)):
        assert torch.equal(compact[k, :n], got[c, s:s + n]), (k, c, s)
    assert (compact[plan.n_live:] == 0).all()


def test_sparse_kernel_more_items_than_a_grid_axis(card):
    """An occupancy-1 schedule at Rs 1: 131,072 live items, more than the
    65,535 blocks of a grid's y axis.  K7 equals K1 bit for bit and its
    plain version within TOL."""
    low = lower_schedule(build_dense_schedule(128, 65.536e-6), 0.0,
                         65.536e-6, 2e9)
    plan = build_sparse_plan(low, Rs=1)
    assert plan.n_live == 131072
    dev = DeviceSchedule(low, card)
    got = synthesize_sparse(dev, plan=plan)
    assert torch.equal(got, synthesize_device(dev))
    plain = kernels.synth_sparse.plain(
        dev, SparseWork.upload(plan, card), torch.zeros_like(got), None)
    assert rel(got.cpu(), plain.cpu()) <= TOL


@pytest.mark.parametrize('padded', [False, True])
def test_probe_sparse_compact_equals_the_sparse_kernel(card, padded):
    """P1 runs K7's item walker: block k of its compact output equals K7's
    subtile of item k bit for bit, padding items store zeros, and a K7
    launch on the padded worklist equals the unpadded one."""
    inp = probes.sparse_inputs(8, 32.768e-6, card)
    dev, plan = inp['dev'], inp['plan']
    work = inp['padded'] if padded else inp['work']
    n = work.work_c.shape[0]
    window = plan.window_samples
    k7 = kernels.synth_sparse(dev, work, torch.zeros((8, window),
                                                     device=card), None)
    assert torch.equal(k7, kernels.synth_sparse(
        dev, inp['work'], torch.zeros_like(k7), None))
    got = kernels.probe_sparse_compact(
        dev, work, torch.full((n, 32, 128), 7.0, device=card)).reshape(n, -1)
    for k, (c, s, m) in enumerate(_live_subtiles(plan)):
        assert torch.equal(got[k, :m], k7[c, s:s + m]), (k, c, s)
    assert (got[plan.n_live:] == 0).all()


def _s1_check(card, coef, x, zi):
    """S1 on the card against the contract of its blocked scan: y and zf
    bit-equal to ``df2t_blocked`` (the kernel's arithmetic, operation for
    operation); the first chunk bit-equal to the sequential ``df2t``, and
    all of y and zf where a row is one chunk; beyond one chunk, no
    farther from scipy's lfilter in np.longdouble than twice df2t's, or
    1e-13 (1e-6 in f32) where that is larger.  A distance is the largest
    over the rows of max|(y, zf) - truth| / max|truth| (chip_smoke.py's
    rows_err), over the rows on which df2t is finite; a kernel output that
    is not finite on such a row is infinitely far."""
    from scipy.signal import lfilter
    from waveforms_tpu_torch.ops import reference_iir
    L = reference_iir.CHUNK
    assert kernels.iir_df2t_chunk() == L
    n = x.shape[1]
    yc, zfc = torch.empty_like(x, device=card), torch.empty_like(zi,
                                                                 device=card)
    before = kernels.iir_df2t.launches
    kernels.iir_df2t(x.to(card), coef.to(card), zi.to(card), yc, zfc)
    torch.cuda.synchronize()
    assert kernels.iir_df2t.launches == before + 1
    yc, zfc = yc.cpu(), zfc.cpu()
    yb, zfb = torch.empty_like(x), torch.empty_like(zi)
    reference_iir.df2t_blocked(x, coef, zi, yb, zfb)
    # equal where finite, NaN where the model is NaN (an f32 clustered row
    # of 300 chunks overflows in both)
    torch.testing.assert_close(yc, yb, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(zfc, zfb, rtol=0, atol=0, equal_nan=True)
    xs = x[:, :min(n, L)].contiguous()
    ys, zfs = torch.empty_like(xs), torch.empty_like(zi)
    reference_iir.df2t(xs, coef, zi, ys, zfs)
    assert torch.equal(yc[:, :L], ys)
    if n <= L:
        assert torch.equal(zfc, zfs)
        return
    ys, zfs = torch.empty_like(x), torch.empty_like(zi)
    reference_iir.df2t(x, coef, zi, ys, zfs)
    c = coef.double().numpy().astype(np.longdouble)
    d = zi.shape[1]
    dist = {'kernel': 0.0, 'sequential': 0.0}
    for r in range(x.shape[0]):
        seq = torch.cat([ys[r], zfs[r]]).double().numpy()
        if not np.isfinite(seq).all():
            continue
        yt, zt = lfilter(c[:d + 1], c[d + 1:],
                         x[r].double().numpy().astype(np.longdouble),
                         zi=zi[r].double().numpy().astype(np.longdouble))
        truth = np.concatenate([yt, zt])
        peak = float(np.abs(truth).max())
        for key, v in (('kernel', torch.cat([yc[r], zfc[r]])),
                       ('sequential', torch.cat([ys[r], zfs[r]]))):
            err = float(np.abs(v.double().numpy() - truth).max()) / peak
            dist[key] = max(dist[key], err if err == err else np.inf)
    floor = 1e-13 if x.dtype == torch.float64 else 1e-6
    assert dist['kernel'] <= max(2 * dist['sequential'], floor), dist


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', list(iir_cases.filters()))
def test_iir_recurrence_kernel_matches_plain(card, name, dtype):
    """S1 against the contract of its blocked scan (_s1_check), y and zf,
    from a non-zero state, over rows that are not a whole number of carry
    blocks and a length that is not a whole number of chunks or tiles."""
    d = len(iir_cases.filters()[name][1]) - 1
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((19, 3001)), dtype=dtype)
    zi = torch.tensor(rng.standard_normal((19, d)) * 0.01, dtype=dtype)
    _s1_check(card, iir_cases.coefficients(*iir_cases.filters()[name],
                                           dtype), x, zi)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', ['one_chunk', 'short', 'many_groups',
                                  'whole_chunks', 'state_16'])
def test_iir_recurrence_kernel_blocked_cases(card, case, dtype):
    """S1's blocked scan at its edges: a row of one chunk and one shorter
    than a tile (bit-equal to df2t throughout); 300 chunks and a part, so
    that a row spans five thread blocks of the chunk passes and ten groups
    of the carry, the last short; 65 chunks over 37 rows, two full carry
    groups in more than one thread block of walkers; a state of 16."""
    from scipy.signal import butter
    from waveforms_tpu_torch.ops import reference_iir
    L = reference_iir.CHUNK
    rows, n, (b, a) = {
        'one_chunk': (5, L, iir_cases.filters()['clustered']),
        'short': (3, 7, iir_cases.filters()['butter5']),
        'many_groups': (3, 300 * L + 17, iir_cases.filters()['clustered']),
        'whole_chunks': (37, 65 * L,
                         iir_cases.filters()['near_unit_double_pole']),
        'state_16': (4, 2 * L + 100, butter(16, 0.3)),
    }[case]
    d = len(a) - 1
    rng = np.random.default_rng(81)
    x = torch.tensor(rng.standard_normal((rows, n)), dtype=dtype)
    zi = torch.tensor(rng.standard_normal((rows, d)) * 0.01, dtype=dtype)
    _s1_check(card, iir_cases.coefficients(b, a, dtype), x, zi)


def test_iir_recurrence_kernel_refusals(card):
    x = torch.zeros(2, 64, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match='1 to 16'):
        kernels.iir_df2t(x, torch.zeros(36, dtype=torch.float64,
                                        device=card),
                         torch.zeros(2, 17, dtype=torch.float64, device=card),
                         torch.empty_like(x),
                         torch.zeros(2, 17, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match='float64 or float32'):
        kernels.iir_df2t(x, torch.zeros(6, device=card),
                         torch.zeros(2, 2, dtype=torch.float64, device=card),
                         torch.empty_like(x),
                         torch.zeros(2, 2, dtype=torch.float64, device=card))


@pytest.mark.parametrize('mode', ['f32', 'int16', 'pair', 'bucketed',
                                  'bf16', 'f16'])
def test_dense_window_equals_the_whole_schedule(card, mode):
    """K1 over windows [row0, row0 + n_out) equals the same columns of its
    unwindowed launch bit for bit, and its plain version's window within
    TOL (a narrowed window: the f32 window rounded once): offsets on and
    off a tile, a ragged last window, a multi-bucket schedule."""
    chans = [(0.5 * wt.cosPulse(300e-9) >> (0.4e-6 + 0.9e-6 * k))
             * wt.cos(2 * np.pi * (90e6 + 7e6 * k)) for k in range(3)]
    low = lower_schedule(chans, 0, 12e-6, 2e9,
                         part='complex' if mode == 'pair' else 'real',
                         bucket_samples=8192 if mode == 'bucketed' else None)
    dev = DeviceSchedule(low, card)
    C, n = low.shape[0], low.n_samples
    dtype = {'int16': torch.int16, 'pair': torch.complex64,
             'bf16': torch.bfloat16, 'f16': torch.float16}.get(
        mode, torch.float32)
    scale = (torch.full((C,), 1000.0, device=card) if mode == 'int16'
             else None)
    whole = kernels.synth_dense(dev, torch.empty(C, n, dtype=dtype,
                                                 device=card), scale)
    for row0 in (0, 128, 8192, 12288, n // 128 * 128 - 1024):
        n_out = min(5000, -(-n // 128) * 128 - row0)
        windowed = kernels.synth_dense.windowed_launches
        got = kernels.synth_dense(dev, torch.empty(C, n_out, dtype=dtype,
                                                   device=card), scale,
                                  row0, n_out)
        # K1's windowed count takes the launches with row0 != 0 only
        assert kernels.synth_dense.windowed_launches == windowed + (row0 > 0)
        stop = min(row0 + n_out, n)
        assert torch.equal(got[:, :stop - row0], whole[:, row0:stop])
        if mode in ('bf16', 'f16'):
            f32 = kernels.synth_dense(dev, torch.empty(C, n_out, device=card),
                                      None, row0, n_out)
            assert torch.equal(got, f32.to(dtype))
            continue
        plain = kernels.synth_dense.plain(
            DeviceSchedule(low, 'cpu'), torch.empty(C, n_out, dtype=dtype),
            None if scale is None else scale.cpu(), row0, n_out)
        if mode == 'int16':
            assert (got.cpu().int() - plain.int()).abs().max() <= 1
        elif mode == 'pair':
            assert rel(got.cpu().real, plain.real) <= TOL
            assert rel(got.cpu().imag, plain.imag) <= TOL
        else:
            assert rel(got.cpu(), plain) <= TOL
    with pytest.raises(ValueError, match='multiple of 128'):
        kernels.synth_dense(dev, torch.empty(C, 128, dtype=dtype,
                                             device=card), scale, 64, 128)


def test_demodulate_ignores_the_callers_tf32(card):
    """An f32 demodulation gives the same IQ points with TF32 on as off:
    the call runs its products at full f32."""
    from waveforms_tpu_torch.ops.demod import demod_matrix, demodulate
    rng = np.random.default_rng(2)
    sig = torch.tensor(rng.standard_normal((64, 200_000)),
                       dtype=torch.float32, device=card)
    m = demod_matrix([11e6, -40e6], 200_000, 2e9, device=card)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = demodulate(sig, m)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = demodulate(sig, m)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(on, off)


def _bucketed_lowering(part='real'):
    """Four channels of 40 ns cosPulses over 32,768 samples in buckets of
    4,096 samples: eight buckets, each with segments."""
    rng = np.random.default_rng(5)
    chans = [wt.WaveVStack([(0.3 * wt.cosPulse(40e-9) >> o)
                            for o in rng.uniform(0, 16e-6, 80)])
             for _ in range(4)]
    if part == 'complex':
        chans = [(0.4 + 0.6j) * w for w in chans]
    return lower_schedule(chans, 0, 16.384e-6, 2e9, part=part,
                          bucket_samples=4096)


@pytest.mark.parametrize('mode', ['f32', 'int16', 'pair'])
def test_dense_bucket0_matches_plain(card, mode):
    """K1 over a time shard's slice of the bucket axis (buckets [b0, b0 +
    nbl), ``bucket0 = b0``, window from b0's first sample) equals the same
    columns of the whole schedule's launch bit for bit, and its plain
    version ``dense_walk(..., bucket0=b0)`` within TOL (int16 within a
    code); the slice's first and last local buckets take the samples
    outside it, as the kernel's clamp gives them."""
    from waveforms_tpu_torch.parallel.mesh import channel_mesh, shard_schedule
    low = _bucketed_lowering('complex' if mode == 'pair' else 'real')
    C, NB = low.shape[:2]
    bs, n = low.bucket_samples, low.n_samples
    dtype = {'int16': torch.int16, 'pair': torch.complex64}.get(
        mode, torch.float32)
    scale = torch.full((C,), 1000.0) if mode == 'int16' else None
    sc = None if scale is None else scale.to(card)
    whole = kernels.synth_dense(DeviceSchedule(low, card),
                                torch.empty(C, n, dtype=dtype, device=card),
                                sc)
    for nt in (2, 4):
        grid, _ = shard_schedule(low, channel_mesh(1, nt, [card] * nt),
                                 nb_pad=NB)
        cpu, _ = shard_schedule(low, channel_mesh(1, nt, ['cpu'] * nt),
                                nb_pad=NB)
        nbl = NB // nt
        for j in range(nt):
            a = j * nbl * bs
            # the shard's own window, and one that runs one bucket past it
            for b in (a + nbl * bs, min(n, a + (nbl + 1) * bs)):
                got = kernels.synth_dense(
                    grid[0][j], torch.empty(C, b - a, dtype=dtype,
                                            device=card), sc, a, b - a,
                    j * nbl)
                plain = kernels.synth_dense.plain(
                    cpu[0][j], torch.empty(C, b - a, dtype=dtype), scale, a,
                    b - a, j * nbl)
                if b == a + nbl * bs:
                    assert torch.equal(got, whole[:, a:b])
                if mode == 'int16':
                    assert (got.cpu().int() - plain.int()).abs().max() <= 1
                elif mode == 'pair':
                    assert rel(got.cpu().real, plain.real) <= TOL
                    assert rel(got.cpu().imag, plain.imag) <= TOL
                else:
                    assert rel(got.cpu(), plain) <= TOL
    with pytest.raises(ValueError, match='bucket0'):
        kernels.synth_dense(DeviceSchedule(low, card),
                            torch.empty(C, n, dtype=dtype, device=card), sc,
                            0, n, -1)


def test_stack_seq_window_matches_whole_and_plain(card):
    """K6 over windows of chunks [chunk0, chunk0 + n) of a two-schedule
    table equals the same columns of its whole-table launch bit for bit, in
    f32 and int16, and its plain version's window within TOL: windows at 0,
    inside, ragged at the end, and one chunk."""
    from waveforms_tpu_torch.ops import StackSequencer
    rng = np.random.default_rng(31)
    lows = [lower_schedule([wt.WaveVStack([
        (float(a) * wt.cosPulse(50e-9) >> o)
        for a, o in zip(rng.uniform(0.2, 1.0, 60),
                        rng.uniform(0, 98e-6, 60))]) for _ in range(3)],
        0.0, 99.9e-6, 2e9, bucket_samples=None) for _ in range(2)]
    seq = StackSequencer(lows, device=card)
    plain_seq = StackSequencer(lows, device='cpu')
    t, n = seq.tables, lows[0].n_samples
    assert t.n_chunks >= 12 and n % 8192
    ks = torch.tensor([1, 0, 7, -2], dtype=torch.int32, device=card)
    span = 64 * 128
    for dtype, scale in ((torch.float32, None),
                         (torch.int16, torch.full((3,), 3000.0))):
        sc = None if scale is None else scale.to(card)
        whole = kernels.synth_stack_seq(
            t, ks, torch.empty((4, 3, n), dtype=dtype, device=card), sc)
        for chunk0, count in ((0, 4), (4, 4), (8, t.n_chunks - 8), (5, 1)):
            a = chunk0 * span
            b = min(n, (chunk0 + count) * span)
            got = kernels.synth_stack_seq(
                t, ks, torch.empty((4, 3, b - a), dtype=dtype, device=card),
                sc, chunk0, count)
            assert torch.equal(got, whole[..., a:b])
            plain = kernels.synth_stack_seq.plain(
                plain_seq.tables, ks.cpu(),
                torch.empty((4, 3, b - a), dtype=dtype), scale, chunk0, count)
            if dtype == torch.int16:
                assert (got.cpu().int() - plain.int()).abs().max() <= 1
            else:
                assert rel(got.cpu().reshape(-1, b - a),
                           plain.reshape(-1, b - a)) <= TOL
    with pytest.raises(ValueError, match='outside'):
        kernels.synth_stack_seq(t, ks, torch.empty((4, 3, 1), device=card),
                                None, t.n_chunks - 1, 2)


def test_offset_zero_matches_the_parent_build(card):
    """K1 at ``bucket0 = 0`` and K6 over a whole table give the outputs of
    the parent build bit for bit (its sources unpacked under build/parent,
    ``git archive <parent> waveforms_tpu_torch | tar -x -C build/parent``,
    and built through tools/ab_dense.py's and tools/ab_stack.py's
    ``other_library``): K1 on every case of this file in f32 and int16, K6
    on a two-schedule table in f32 and int16."""
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    tree = repo / 'build' / 'parent'
    if not (tree / 'waveforms_tpu_torch' / 'csrc').is_dir():
        pytest.skip("no parent tree under build/parent to compare with")
    sys.path.insert(0, str(repo / 'tools'))
    import ab_dense
    import ab_stack
    from waveforms_tpu_torch.ops import StackSequencer
    dense_lib, largest, _ = ab_dense.other_library(tree)
    stack_lib, _ = ab_stack.other_library(tree)
    for case in _cases():
        low = _lowered(case)
        C, n = low.shape[0], low.n_samples
        dev = DeviceSchedule(low, card)
        for dtype in (torch.float32, torch.int16):
            sc = (torch.full((C,), 1000.0, device=card)
                  if dtype == torch.int16 else None)
            mine = kernels.synth_dense(
                dev, torch.empty(C, n, dtype=dtype, device=card), sc)
            theirs = torch.empty(C, n, dtype=dtype, device=card)
            kernels.launch_dense(dev, theirs, sc, lib=dense_lib,
                                 largest=largest)
            assert torch.equal(mine, theirs), (case, dtype)
    rng = np.random.default_rng(32)
    lows = [lower_schedule([wt.WaveVStack([
        (0.5 * wt.cosPulse(50e-9) >> o) for o in rng.uniform(0, 30e-6, 40)])
        for _ in range(2)], 0.0, 32.768e-6, 2e9, bucket_samples=None)
        for _ in range(2)]
    seq = StackSequencer(lows, device=card)
    ks = torch.tensor([1, 0, 5, -1], dtype=torch.int32, device=card)
    for dtype, sc in ((torch.float32, None),
                      (torch.int16, torch.full((2,), 3000.0, device=card))):
        mine = seq.play_packed(ks, out_dtype=dtype, dac_scale=3000.0)
        theirs = torch.empty_like(mine)
        kernels.launch_stack_seq(seq.tables, ks, theirs, sc, lib=stack_lib)
        assert torch.equal(mine, theirs), dtype


def test_sharded_routes_on_one_card(card):
    """One sharded call per route on a (2, 2) mesh of one card, each block
    on the card: the dense (K1, windowed, bucketed), panel (K2) and
    worklist (K7) paths bit-equal to the same kernel on the whole
    schedule, the stacked-table path (K6) within TOL of K5 on the whole
    schedule, and each kernel launched once a shard."""
    from waveforms_tpu_torch.ops.sparse_synth import (
        synthesize_panels_sharded, synthesize_sparse_sharded)
    from waveforms_tpu_torch.ops.stack_seq import synthesize_stack_sharded
    from waveforms_tpu_torch.parallel.mesh import (channel_mesh,
                                                   synthesize_sharded)
    mesh = channel_mesh(2, 2, devices=[card] * 4)
    low = _bucketed_lowering()
    dev = DeviceSchedule(low, card)

    def counted(name, fn):
        kernel = getattr(kernels, name)
        n = kernel.launches
        plane = fn()
        assert kernel.launches == n + 4, name
        assert all(b.device.type == 'cuda' for row in plane.blocks
                   for b in row)
        return plane.gather()

    got = counted('synth_dense', lambda: synthesize_sharded(low, mesh))
    assert torch.equal(got, synthesize_device(dev))
    got = counted('synth_panel',
                  lambda: synthesize_panels_sharded(low, mesh, Rs=8))
    assert torch.equal(got, synthesize_panels(dev, low, Rs=8))
    got = counted('synth_sparse',
                  lambda: synthesize_sparse_sharded(low, mesh, Rs=8))
    assert torch.equal(got, synthesize_sparse(dev, low, Rs=8))
    rng = np.random.default_rng(33)
    chans = [wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                            for o in rng.uniform(0, 60e-6, 50)])
             for _ in range(4)]
    got = counted('synth_stack_seq', lambda: synthesize_stack_sharded(
        chans, 0.0, 65.536e-6, 2e9, mesh))
    whole = lower_schedule(chans, 0.0, 65.536e-6, 2e9, bucket_samples=None)
    assert rel(got.cpu(), synthesize_stack(whole, device=card).cpu()) <= TOL


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('d', [1, 3, 16])
def test_iir_state_only_call_writes_the_full_calls_zf(card, d, dtype):
    """S1's state-only call (y None: the chunk pass, the carry and a walk of
    each row's last chunk) writes the full call's zf bit for bit, and the
    plain model's state-only zf; rows of one chunk, of whole chunks, and of
    a ragged last chunk over several carry groups; counted in
    ``state_launches``."""
    from scipy.signal import butter
    from waveforms_tpu_torch.ops import reference_iir
    L = reference_iir.CHUNK
    b, a = (iir_cases.filters()['clustered'] if d == 3 else butter(d, 0.3))
    coef = iir_cases.coefficients(b, a, dtype).to(card)
    rng = np.random.default_rng(d)
    for n in (300, 4 * L, 70 * L + 33):
        x = torch.tensor(rng.standard_normal((5, n)), dtype=dtype,
                         device=card)
        zi = torch.tensor(rng.standard_normal((5, d)) * 0.01, dtype=dtype,
                          device=card)
        zf, zs = torch.empty_like(zi), torch.empty_like(zi)
        kernels.iir_df2t(x, coef, zi, torch.empty_like(x), zf)
        n0 = (kernels.iir_df2t.launches, kernels.iir_df2t.state_launches)
        assert kernels.iir_df2t(x, coef, zi, None, zs) is zs
        assert (kernels.iir_df2t.launches,
                kernels.iir_df2t.state_launches) == (n0[0] + 1, n0[1] + 1)
        torch.testing.assert_close(zs, zf, rtol=0, atol=0, equal_nan=True)
        zb = torch.empty_like(zi).cpu()
        reference_iir.df2t_blocked(x.cpu(), coef.cpu(), zi.cpu(), None, zb)
        torch.testing.assert_close(zs.cpu(), zb, rtol=0, atol=0,
                                   equal_nan=True)


def test_shard_carry_on_the_card_equals_the_plain_one(card):
    """ops.iir.shard_carry on card tensors (the state maps on the host, the
    steps in double-double torch on the card) within 1e-15 of the largest
    state of the plain carry on the CPU."""
    from waveforms_tpu_torch.ops import iir, reference_iir
    b, a = iir_cases.filters()['clustered']
    rng = np.random.default_rng(4)
    zf0 = torch.from_numpy(rng.standard_normal((64, 8, 3)) * 1e-3)
    zi = torch.from_numpy(rng.standard_normal((64, 3)) * 1e-3)
    lengths = [250_000] * 7 + [1000]
    plain = reference_iir.shard_carry(iir_cases.coefficients(b, a), zf0,
                                      lengths, zi)
    got = iir.shard_carry(b, a, zf0.to(card), lengths, zi.to(card))
    assert got.device.type == 'cuda'
    assert (got.cpu() - plain).abs().max() <= 1e-15 * plain.abs().max()


def test_multiproc_smoke_on_the_card():
    """python -m waveforms_tpu_torch.parallel.multiproc_smoke --device cuda
    --backend gloo at small size, both layouts: two processes on the card
    (one each where there are two), exit 0."""
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, '-m', 'waveforms_tpu_torch.parallel.multiproc_smoke',
         '--device', 'cuda', '--backend', 'gloo', '--layout', 'jax', 'time'],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-4000:]
    assert res.stdout.strip().splitlines()[-1] == 'MULTIPROC OK'


def _card_route_cases():
    """name -> (call on a (rows, n) signal, its answer in np.longdouble on
    numpy rows or None, S1 calls, complex doubling scans)."""
    from scipy.signal import butter, lfilter, tf2sos
    from waveforms_tpu_torch.distortion import (combine_filters,
                                                exp_decay_filter)
    from waveforms_tpu_torch.ops import iir
    from waveforms_tpu_torch.schedules import FS
    ld = np.longdouble
    b_s, a_s = combine_filters([exp_decay_filter(a, t, FS, inv=True)
                                for a, t in zip([0.02, 0.005],
                                                [3e-6, 20e-6])])
    z_c, p_c, k_c = exp_decay_filter(*iir_cases.CLUSTERED, FS,
                                     output='zpk')
    sos = tf2sos(*butter(3, 0.02))
    zi = np.random.default_rng(2).standard_normal((4, 2, 2)) * 0.1
    mixed = ([0.999, 0.9 * np.exp(0.3j), 0.9 * np.exp(-0.3j)],
             [0.9995, 0.95 * np.exp(0.2j), 0.95 * np.exp(-0.2j), 0.5], 0.2)

    def ba_truth(b, a):
        c = iir_cases.coefficients(b, a).numpy().astype(ld)
        d = len(c) // 2 - 1
        return lambda xs: [lfilter(c[:d + 1], c[d + 1:], h.astype(ld))
                           for h in xs]

    def sos_truth(xs):
        out = []
        for r, h in enumerate(xs):
            y = h.astype(ld)
            for k, s in enumerate(sos):
                y = lfilter(s[:3].astype(ld) / ld(s[3]),
                            s[3:].astype(ld) / ld(s[3]), y,
                            zi=zi[r, k].astype(ld))[0]
            out.append(y)
        return out

    def zpk_truth(xs):
        zr, pr = sorted(np.real(z_c))[::-1], sorted(np.real(p_c))[::-1]
        out = []
        for h in xs:
            y = h.astype(ld) * ld(k_c)
            for zero, pole in zip(zr, pr):
                y = lfilter(np.array([1, -zero], ld),
                            np.array([1, -pole], ld), y)
            out.append(y)
        return out
    return {
        'lfilter_z_settle': (lambda x: iir.lfilter(b_s, a_s, x),
                             ba_truth(b_s, a_s), 1, 0),
        'lfilter_clustered': (lambda x: iir.lfilter(
            *iir_cases.filters()['clustered'], x),
            ba_truth(*iir_cases.filters()['clustered']), 1, 0),
        'sosfilt_zi': (lambda x: iir.sosfilt(
            sos, x, zi=torch.from_numpy(zi).to(x.device))[0], sos_truth,
            2, 0),
        'iir_apply': (lambda x: iir.iir_apply(sos, x), None, 2, 0),
        'filter_zpk_clustered': (lambda x: iir.filter_zpk(z_c, p_c, k_c, x),
                                 zpk_truth, 3, 0),
        'filter_zpk_mixed': (lambda x: iir.filter_zpk(*mixed, x), None, 2,
                             2),
    }


@pytest.mark.parametrize('name', ['lfilter_z_settle', 'lfilter_clustered',
                                  'sosfilt_zi', 'iir_apply',
                                  'filter_zpk_clustered', 'filter_zpk_mixed'])
def test_signal_chain_runs_s1_on_the_card(card, name, monkeypatch):
    """On CUDA tensors every real section of lfilter, sosfilt (with zi),
    iir_apply and filter_zpk launches S1, one call a section, and never
    the doubling scan; complex pole pairs alone take the complex doubling
    scan (two AR1 scans a pair).  Against the same call on the CPU through
    S1's plain version (``_route`` answering as for the card): the first
    chunk bit-equal, and no farther from the long-double answer than twice
    the plain version, or 1e-13 of the peak (chip_smoke.py's contract);
    with a complex pair, within 1e-12 of the peak of the plain route."""
    from waveforms_tpu_torch.ops import iir, reference_iir
    call, truth, n_s1, n_complex = _card_route_cases()[name]
    route = iir._route
    monkeypatch.setattr(iir, '_route', lambda dev, *a, **kw: route(
        card, *a, **kw))
    seen = {'_doubling_df2t': 0, '_ar1_doubling': 0}
    for fn in seen:
        real = getattr(iir, fn)

        def spy(*a, _real=real, _fn=fn, **kw):
            seen[_fn] += 1
            assert _fn == '_ar1_doubling' and np.iscomplexobj(a[0])
            return _real(*a, **kw)
        monkeypatch.setattr(iir, fn, spy)
    x = torch.from_numpy(iir_cases.pulse_train(20_000, 3)[None]
                         * np.linspace(0.5, 1.5, 4)[:, None])
    plain = call(x)
    seen.update({'_doubling_df2t': 0, '_ar1_doubling': 0})
    kernels.reset_launch_counts()
    got = call(x.to(card))
    torch.cuda.synchronize()
    assert kernels.iir_df2t.launches == n_s1
    assert seen == {'_doubling_df2t': 0, '_ar1_doubling': n_complex}
    assert got.dtype == torch.float64 and got.shape == x.shape
    got = got.cpu()
    L = reference_iir.CHUNK
    if n_complex:
        assert rel(got, plain) <= 1e-12
        return
    assert torch.equal(got[:, :L], plain[:, :L])
    if truth is None:
        assert rel(got, plain) <= 1e-12
        return
    want = truth(x.numpy())
    dist = {}
    for key, v in (('kernel', got), ('plain', plain)):
        dist[key] = max(float(np.abs(r.numpy() - w).max() / np.abs(w).max())
                        for r, w in zip(v, want))
    assert dist['kernel'] <= max(2 * dist['plain'], 1e-13), dist


def test_lfilter_zf_on_the_card_is_lfilters_zf(card):
    """lfilter_zf of a CUDA tensor is S1's state-only call, bit-equal to
    lfilter's zf on the same rows and state."""
    from waveforms_tpu_torch.ops import iir
    b, a = iir_cases.filters()['clustered']
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 9000))).to(card)
    zi = torch.from_numpy(rng.standard_normal((6, 3)) * 0.01).to(card)
    kernels.reset_launch_counts()
    zf = iir.lfilter_zf(b, a, x, route_n=2_000_000, zi=zi)
    assert (kernels.iir_df2t.launches, kernels.iir_df2t.state_launches) == (
        1, 1)
    _, want = iir.lfilter(b, a, x, zi=zi, route_n=2_000_000)
    assert torch.equal(zf, want)


def test_lfilter_f32_on_the_card(card):
    """An f32 signal on the card runs S1's f32 build (its chunk pass and
    carry in f64): f32 out, within 1e-6 of the peak of scipy's f64 answer
    on the same f32 samples."""
    from scipy.signal import butter, lfilter
    from waveforms_tpu_torch.ops import iir
    b, a = butter(2, 0.3)
    x = np.random.default_rng(6).standard_normal((3, 50_000)).astype(
        np.float32)
    kernels.reset_launch_counts()
    y = iir.lfilter(b, a, torch.from_numpy(x).to(card))
    assert y.dtype == torch.float32 and kernels.iir_df2t.launches == 1
    assert rel(y.cpu(), lfilter(b, a, x.astype(np.float64))) <= 1e-6


def test_iir_kernel_equals_the_model_through_underflow(card):
    """A single exponential (pole 1 - 1/190) over rows whose pulses end
    early: over the quiet rest of 136,000 samples the state decays into
    the subnormal range, where the double-double products' error terms
    underflow (Dekker's split of the operands gives other bits there).  The
    full call and the state-only call stay bit-equal to the plain model
    (whose TwoProd gives the fused multiply-add's error there too)."""
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import reference_iir
    from waveforms_tpu_torch.schedules import FS
    b, a = exp_decay_filter(0.05, 100e-9, FS, inv=True)
    coef = iir_cases.coefficients(b, a).to(card)
    rng = np.random.default_rng(12)
    x = np.zeros((4, 139_000))
    x[:, :3000] = rng.standard_normal((4, 3000))
    x = torch.from_numpy(x).to(card)
    zi = torch.zeros((4, 1), dtype=torch.float64, device=card)
    y, zf, zs = torch.empty_like(x), torch.empty_like(zi), torch.empty_like(zi)
    kernels.iir_df2t(x, coef, zi, y, zf)
    kernels.iir_df2t(x, coef, zi, None, zs)
    yb, zb = torch.empty_like(x).cpu(), torch.empty_like(zi).cpu()
    reference_iir.df2t_blocked(x.cpu(), coef.cpu(), zi.cpu(), yb, zb)
    assert 0 < float(zb.abs().max()) < 2.0 ** -1022     # subnormal
    assert torch.equal(y.cpu(), yb)
    assert torch.equal(zf.cpu(), zb) and torch.equal(zs.cpu(), zb)


# -- T1, the trace evaluator ---------------------------------------------------

TOL_TRACE = 1e-12     # T1 vs its plain version in float64, of the peak


def rel_c(a, b):
    """rel, complex values by modulus."""
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def _parts(chans, part):
    return [c.simplify() if part != 'real' and isinstance(c, wt.WaveVStack)
            else c for c in chans]


@pytest.mark.parametrize('name', list(trace_cases.CASES))
def test_trace_eval_matches_plain_and_oracle(card, name):
    """Each case's channels in one T1 launch a part, against the plain
    version on the CPU; each channel's ``evaluate`` on the card against
    the oracle."""
    chans, grid, (rtol, atol) = trace_cases.cases(wt)[name]
    g = torch.from_numpy(grid)
    for part in ('real', 'imag', 'complex'):
        chs = _parts(chans, part)
        n = kernels.trace_eval.launches
        got = torch_eval.evaluate_channels(chs, g.to(card), part)
        assert kernels.trace_eval.launches == n + 1
        plain = torch_eval.evaluate_channels(chs, g, part)
        assert got.dtype == plain.dtype and got.shape == plain.shape
        assert rel_c(got.cpu(), plain) <= TOL_TRACE, part
    if rtol is None:
        return
    order = np.argsort(grid, kind='stable')
    for ch in chans:
        got = torch_eval.evaluate(ch, g.to(card)).cpu().numpy()[order]
        np.testing.assert_allclose(got, np.asarray(ch(grid[order])),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize('name', ['gaussian', 'cos', 'drag', 'mollifier',
                                  'multi-channel', 'vstack', 'drag-sinx'])
def test_trace_eval_float32_grid(card, name):
    chans, grid, _ = trace_cases.cases(wt)[name]
    g = torch.from_numpy(grid.astype(np.float32))
    for part in ('real', 'complex'):
        chs = _parts(chans, part)
        got = torch_eval.evaluate_channels(chs, g.to(card), part)
        assert got.dtype == (torch.float32 if part == 'real'
                             else torch.complex64)
        plain = torch_eval.evaluate_channels(chs, g, part)
        got = got.cpu()
        # float32 overflows where the plain version's does (drag_sinx's
        # blend polynomials at ns scale): the same samples, NaN in both
        nan = torch.isnan(plain)
        assert torch.equal(torch.isnan(got), nan)
        assert rel_c(got.masked_fill(nan, 0), plain.masked_fill(nan, 0)) \
            <= TOL


def test_engine_torch_is_one_trace_launch(card):
    """synthesize(engine='torch') on the card: one T1 launch and no other
    kernel, each part equal to the CPU's plain version; int16 codes
    quantized from it; sample_waveform (f32 grid) and the CLI's default
    path one launch each."""
    from waveforms_tpu_torch.__main__ import _synthesize
    chans = trace_cases.cases(wt)['multi-channel'][0]
    for part in ('real', 'imag', 'complex'):
        kernels.reset_launch_counts()
        got = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                            part=part, device='cuda')
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        assert counts == {'trace_eval': 1}
        plain = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                              part=part, device='cpu')
        assert rel_c(got.cpu(), plain) <= TOL_TRACE
    codes = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                          device='cuda', out_dtype=torch.int16,
                          dac_scale=1000.0)
    plain = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                          device='cpu', out_dtype=torch.int16,
                          dac_scale=1000.0)
    assert int((codes.cpu().int() - plain.int()).abs().max()) <= 1
    wav = wt.gaussian(4e-9) * wt.cos(2 * np.pi * 0.3e9)
    wav.start, wav.stop, wav.sample_rate = -5e-9, 5e-9, 2e10
    n = kernels.trace_eval.launches
    f32 = torch_eval.sample_waveform(wav, dtype=np.float32, device='cuda')
    cli = _synthesize(wav, 'torch', 'cuda')
    assert kernels.trace_eval.launches == n + 2
    assert f32.dtype == torch.float32 and cli.dtype == np.float64
    assert rel(f32.cpu(), torch_eval.sample_waveform(
        wav, dtype=np.float32, device='cpu')) <= TOL
    np.testing.assert_allclose(cli, wav.sample(), rtol=1e-9, atol=1e-12)


def _nan_equal(got, want, tol):
    """The same NaN samples, the rest within ``tol`` of the peak."""
    g = torch.view_as_real(got) if got.is_complex() else got
    w = torch.view_as_real(want) if want.is_complex() else want
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan)
    assert rel_c(g.masked_fill(nan, 0).reshape(len(g), -1),
                 w.masked_fill(nan, 0).reshape(len(w), -1)) <= tol


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_trace_eval_nan_and_infinite_samples(card, dtype):
    """A NaN sample lies outside every segment (0) unless the waveform is
    one unbounded segment, which evaluates it, and +inf too (T1 at 4cdb121
    put a NaN sample in the first segment, and +inf past a lone unbounded
    one); T1 against its plain version on unsorted tiles (NaN, inf) and
    sorted ones (-inf first)."""
    chans = [wt.cos(3.0) + wt.square(2), wt.cos(3.0), wt.gaussian(2) >> 0.5,
             wt.WaveVStack([wt.cos(3.0) + wt.square(2), wt.gaussian(1)])
             >> 0.1, (wt.cos(1.0) * (wt.square(1.0) >> -2.0))
             + 0.5 * wt.exp(-0.3 + 2j) * (wt.square(1) >> 2)]
    grid = np.sort(np.random.default_rng(5).uniform(-4, 4, 6001))
    grid[[7, 2500, 4100]] = np.nan
    grid[[9, 2600]] = np.inf
    grid[0] = -np.inf
    g = torch.from_numpy(grid.astype(dtype))
    tol = TOL_TRACE if dtype == np.float64 else TOL
    for part in ('real', 'imag', 'complex'):
        chs = _parts(chans, part)
        got = torch_eval.evaluate_channels(chs, g.to(card), part).cpu()
        _nan_equal(got, torch_eval.evaluate_channels(chs, g, part), tol)
        if part == 'real':
            assert (got[0, [7, 2500, 4100]] == 0).all()
            assert torch.isnan(got[1, [7, 9, 2500]]).all()


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('part', ['real', 'imag', 'complex'])
def test_trace_eval_odd_sample_counts(card, part, dtype):
    """Odd N (a ragged last tile, rows that start off 16-byte alignment,
    mode 2's pairs), a real and a complex tape, against the plain
    version."""
    chans, grid, _ = trace_cases.cases(wt)['tiles-real-complex']
    tol = TOL_TRACE if dtype == np.float64 else TOL
    for n in (1, 3, 2047, 2049, 6161):
        g = torch.from_numpy(np.ascontiguousarray(grid[:n].astype(dtype)))
        for group in (chans[:1], chans):
            got = torch_eval.evaluate_channels(group, g.to(card), part)
            plain = torch_eval.evaluate_channels(group, g, part)
            assert got.shape == plain.shape and got.dtype == plain.dtype
            assert rel_c(got.cpu(), plain) <= tol, (n, len(group))


def test_trace_eval_permuted_grid_is_the_sorted_grid_permuted(card):
    """A sample's value depends on its t alone: T1 over a permuted grid
    (every tile unsorted, searched per sample) is its output over the
    sorted grid (tiles in one segment stored or evaluated without a
    search) permuted, bit for bit."""
    from waveforms_tpu_torch.schedules import build_schedule
    chans = build_schedule()[:16]
    grid = np.arange(0.0, 2e-4, 1 / 2e9)
    perm = np.random.default_rng(0).permutation(len(grid))
    for part in ('real', 'complex'):
        ref = torch_eval.evaluate_channels(
            chans, torch.from_numpy(grid).to(card), part)
        got = torch_eval.evaluate_channels(
            chans, torch.from_numpy(grid[perm]).to(card), part)
        assert torch.equal(got, ref[:, torch.from_numpy(perm).to(card)])


def test_trace_eval_complex_args_stay_on_the_card(card):
    """Built-ins with complex arguments run on the card: T1 evaluates exp,
    cos, cosh, sinh, sinc, gaussian and interp's points complex, and a
    chirp with a complex phase is an external slot filled on the card --
    one launch under set_sync_debug_mode('error'), where a copy to the
    host raises; against the plain version on the CPU and the oracle (the
    CPU tests hold the plain version to JAX)."""
    from waveforms_tpu_torch.ops import trace_tape
    for name in ('complex-args', 'interp-complex'):
        chans, grid, (rtol, atol) = trace_cases.cases(wt)[name]
        tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                        for c in chans))
        g = torch.from_numpy(grid).to(card)
        tape.tensors(card)
        torch.cuda.synchronize()
        n = kernels.trace_eval.launches
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = trace_tape.run(tape, g, 'complex')
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert kernels.trace_eval.launches == n + 1
        plain = trace_tape.run(tape, g.cpu(), 'complex')
        assert got.dtype == plain.dtype == torch.complex128
        assert rel_c(got.cpu(), plain) <= TOL_TRACE
        order = np.argsort(grid, kind='stable')
        for row, ch in zip(got.cpu().numpy(), chans):
            np.testing.assert_allclose(row[order],
                                       np.asarray(ch(grid[order])),
                                       rtol=rtol, atol=atol)
