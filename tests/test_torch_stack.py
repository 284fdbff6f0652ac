"""The stack route: the port's planner and the stack kernel's plain version
against the JAX package's stack path.

The same lowered schedule (lowered by the JAX package, copied into the
port's ``LoweredSchedule``) goes through ``waveforms_tpu.ops.stack_synth``
(``build_stack_plan``; ``synthesize_stack(..., interpret=True)`` as
tests/test_stack_synth.py runs it on the CPU) and through the port's
``ops/stack_synth.py`` on ``device='cpu'``, where the stack kernel
(``csrc/synth_stack.cu``) runs as its plain version
``ops.reference.stack_eval`` and the wide residual through the dense
kernel's plain version.

Tolerances: plans array-equal; samples within 1e-6 of each channel's peak
of the JAX result (both f32, same formulas, different summation order) and
the JAX suite's 2e-6 of the float64 oracle; int16 codes within one code of
JAX's (the f32 sums they quantize may differ in the last bit).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.stack_synth as sj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops.stack_synth import (CHUNK_ROWS, CTA_CHUNKS,
                                                 STAGE_BLOCKS, STAGE_WORDS,
                                                 StackTables,
                                                 build_stack_plan,
                                                 build_stack_tables,
                                                 chunk_staging,
                                                 synthesize_stack)
from test_torch_lowering import ARRAYS
from test_torch_synth import RTOL, TOL_JAX, oracle, rel

FS = 2e9
GROUP_FIELDS = ('amp', 'lo', 'hi', 'row0', 'chan', 'shift', 'q32', 'args')


def cases():
    """(channels, stop, bucket_samples, part): the schedules of
    tests/test_stack_synth.py, cut to a few channels and ~10 us."""
    rng = np.random.default_rng(7)
    vstack = wj.WaveVStack([(0.5 * wj.cosPulse(50e-9) >> o)
                            for o in rng.uniform(0, 9e-6, 200)])
    overlap = wj.zero()
    for _ in range(40):
        overlap += wj.drag(100e6, 300e-9, plateau=200e-9, delta=2e6,
                           block_freq=None, phase=rng.uniform(0, 6),
                           t0=0.0) >> rng.uniform(0, 0.6e-6)
    carrier = 0.1 * wj.cos(2 * np.pi * 150e6) + 0.05
    for _ in range(30):
        carrier += 0.4 * (wj.cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    pulses = wj.zero()
    for _ in range(20):
        pulses += 0.3 * (wj.cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    bucketed = wj.WaveVStack([(0.4 * wj.cosPulse(400e-9) >> o)
                              for o in rng.uniform(0, 7e-6, 50)])
    ds = wj.zero()
    p = wj.drag_sin(5e9, 20e-9, plateau=10e-9, delta=1e6)
    for _ in range(15):
        ds += p >> rng.uniform(0, 7e-6)
    mixed = wj.zero()
    for _ in range(25):
        I, _ = wj.mixing(0.5 * wj.cosPulse(20e-9) >> rng.uniform(0, 7e-6),
                         freq=-150e6, DRAGScaling=1e-10)
        mixed += I
    imag = wj.WaveVStack([((0.3 + 0.7j) * wj.cosPulse(60e-9) >> o)
                          for o in rng.uniform(0, 7e-6, 40)])
    sparse = wj.WaveVStack([(0.5 * wj.cosPulse(50e-9) >> o)
                            for o in (0.3e-6, 0.31e-6, 10.4e-6, 19.9e-6)])
    return {
        'vstack': ([vstack, vstack >> 1e-7], 10e-6, 'auto', 'real'),
        'overlap_drag': ([overlap], 1.1e-6, 'auto', 'real'),
        'mixed_wide': ([carrier, wj.gaussian(7e-6) >> 3.5e-6], 8.192e-6,
                       'auto', 'real'),
        'bucketed': ([bucketed], 8.192e-6, 2048, 'real'),
        'clipped': ([wj.cut(2.0 * (wj.gaussian(2e-6) >> 4e-6), max=1.2),
                     pulses], 8.192e-6, 'auto', 'real'),
        'multitone_drag': ([ds], 8.192e-6, 'auto', 'real'),
        'mixing_drag': ([mixed], 8.192e-6, 'auto', 'real'),
        'imag': ([imag], 8.192e-6, 'auto', 'imag'),
        # 16,381 samples: the kernels store such rows sample by sample
        'odd_length': ([vstack, vstack >> 1e-7], 8.1905e-6, 'auto', 'real'),
        # 40,000 samples in 10 chunks, 4 of them without a block
        'empty_chunks': ([sparse, sparse >> 2e-6], 20e-6, 'auto', 'real'),
    }


def lowered(case):
    chans, stop, bs, part = cases()[case]
    low = lower_j(chans, 0.0, stop, FS, bucket_samples=bs, part=part)
    return chans, stop, part, low, lowered_from_jax(low)


def host_oracle(chans, stop, part):
    if part == 'real':
        return oracle(chans, 0.0, stop, FS)
    t = np.arange(0.0, stop, 1 / FS)
    return np.stack([np.imag(np.asarray(w.simplify()(t))) for w in chans])


@pytest.mark.parametrize('case', list(cases()))
def test_build_stack_plan_matches_jax(case):
    _, _, _, low, low_t = lowered(case)
    before = {n: np.copy(getattr(low_t, n)) for n in ARRAYS}
    plan_j = sj.build_stack_plan(low)
    plan_t = build_stack_plan(low_t)
    assert plan_j is not None and plan_t is not None
    for name in ('n_narrow', 'n_blocks_total', 'kernel_samples',
                 'batch_samples', 'n_rows', 'n_channels', 'n_samples'):
        assert getattr(plan_t, name) == getattr(plan_j, name), name
    assert plan_t.advantage == plan_j.advantage
    assert len(plan_t.groups) == len(plan_j.groups)
    for gt, gj in zip(plan_t.groups, plan_j.groups):
        assert (gt.ops, gt.powers, gt.term_nfac) == (gj.ops, gj.powers,
                                                     gj.term_nfac)
        for name in GROUP_FIELDS:
            np.testing.assert_array_equal(getattr(gt, name),
                                          getattr(gj, name), err_msg=name)
    assert (plan_t.wide is None) == (plan_j.wide is None)
    if plan_t.wide is not None:
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(plan_t.wide, name),
                                          getattr(plan_j.wide, name),
                                          err_msg=name)
    # the residual is a copy: the caller's schedule is not permuted
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(low_t, name), before[name],
                                      err_msg=name)


@pytest.mark.parametrize('case', list(cases()))
def test_stack_tables_hold_jax_blocks(case):
    """The kernel's CSR block list holds each group's blocks as the JAX
    package's ``_chunk_assign`` places them, each in its own (channel,
    CHUNK_ROWS-row chunk)."""
    _, _, _, low, low_t = lowered(case)
    plan_j = sj.build_stack_plan(low)
    plan_t = build_stack_plan(low_t)
    t = build_stack_tables(plan_t, low_t, 'cpu')
    bi, br = t.blk_inst.numpy(), t.blk_row.numpy()
    start = t.chunk_start.numpy()
    assert start[0] == 0 and start[-1] == t.n_blocks == plan_t.n_blocks_total
    q = np.repeat(np.arange(len(start) - 1), np.diff(start))
    chan = t.inst.numpy()[bi, 0]
    np.testing.assert_array_equal(q, chan * t.n_chunks + br // CHUNK_ROWS)
    n_chunks_j = -(-plan_j.n_channels * plan_j.n_rows // 128)
    m0 = 0
    for g in plan_j.groups:
        src, rb, _, _, _ = sj._chunk_assign(g, plan_j.n_rows, n_chunks_j, 1)
        want = sorted(zip(src[src >= 0] + m0, rb[src >= 0]))
        mine = (bi >= m0) & (bi < m0 + len(g.amp))
        assert sorted(zip(bi[mine], br[mine])) == want
        m0 += len(g.amp)


@pytest.mark.parametrize('case', list(cases()))
def test_synthesize_stack_matches_jax_and_oracle(case):
    chans, stop, part, low, low_t = lowered(case)
    ref = np.asarray(sj.synthesize_stack(low, sj.build_stack_plan(low),
                                         interpret=True))
    n = kernels.synth_stack.launches
    got = synthesize_stack(low_t, build_stack_plan(low_t), device='cpu')
    assert kernels.synth_stack.launches == n        # plain version only
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel(got.numpy(), ref) <= TOL_JAX
    assert rel(got.numpy(), host_oracle(chans, stop, part)) <= RTOL


@pytest.mark.parametrize('case', ['vstack', 'mixed_wide'])
def test_int16_codes_match_jax(case):
    """Without a residual the kernel quantizes (a scalar dac_scale); with
    one, the f32 sum is quantized after it -- in both packages."""
    _, _, _, low, low_t = lowered(case)
    plan_t = build_stack_plan(low_t)
    assert (plan_t.wide is None) == (case == 'vstack')
    ref = np.asarray(sj.synthesize_stack(low, sj.build_stack_plan(low),
                                         interpret=True, out_dtype=jnp.int16,
                                         dac_scale=30000.0))
    got = synthesize_stack(low_t, plan_t, out_dtype=torch.int16,
                           dac_scale=30000.0, device='cpu').numpy()
    assert got.dtype == np.int16 and ref.dtype == np.int16
    assert np.abs(got.astype(int) - ref).max() <= 1
    f32 = synthesize_stack(low_t, plan_t, device='cpu')
    want = torch.clamp(torch.round(f32 * 30000.0), -32768, 32767)
    np.testing.assert_array_equal(got, want.to(torch.int16).numpy())


def test_per_channel_scale_quantizes_after_the_kernel():
    """A per-channel dac_scale is applied after the stack kernel, even
    without a residual (the JAX package's rule)."""
    _, _, _, _, low_t = lowered('vstack')
    plan = build_stack_plan(low_t)
    scales = np.array([20000.0, 30000.0], np.float32)
    got = synthesize_stack(low_t, plan, out_dtype=np.int16,
                           dac_scale=scales, device='cpu')
    f32 = synthesize_stack(low_t, plan, device='cpu')
    want = torch.clamp(torch.round(f32 * torch.as_tensor(scales)[:, None]),
                       -32768, 32767).to(torch.int16)
    assert torch.equal(got, want)


def test_stack_constants_match_the_kernels():
    """CHUNK_ROWS and the staging sizes are one constant each, shared by
    the host's tables and the stack kernels' header."""
    text = (kernels.CSRC / 'synth_stack_common.cuh').read_text()
    for name, value in (('CHUNK_ROWS', CHUNK_ROWS),
                        ('CTA_CHUNKS', CTA_CHUNKS),
                        ('STAGE_BLOCKS', STAGE_BLOCKS),
                        ('STAGE_WORDS', STAGE_WORDS)):
        m = re.search(rf'constexpr int {name} = (\d+);', text)
        assert m is not None and int(m.group(1)) == value, name


def _block_tables(blk_inst, chunk_start, n_chunks, NT=1, TF=1):
    """StackTables holding only a block list (the instance arrays empty),
    one channel of ``n_chunks`` chunks."""
    def i32(a):
        return torch.tensor(a, dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    return StackTables(
        n_channels=1, n_samples=128 * CHUNK_ROWS * n_chunks,
        n_chunks=n_chunks, NT=NT, TF=TF, inst=empty, amp=empty.float(),
        term_nfac=empty, op=empty, power=empty, shift_hi=empty, q32=empty,
        args=empty.float(), ext=torch.zeros(1), blk_inst=i32(blk_inst),
        blk_row=i32([0] * len(blk_inst)), chunk_start=i32(chunk_start))


def test_chunk_staging_counts_each_run_of_an_instance_once():
    """A thread block takes CTA_CHUNKS chunks; a run of consecutive blocks
    of one instance takes one staging slot, across the chunks of one thread
    block too, and a thread block's first block opens a slot even when the
    previous one ended on the same instance.  A thread block is staged when
    its blocks and its slots' descriptors fit; an empty one always is."""
    G = CTA_CHUNKS
    # thread block 0: chunk 0 holds [0, 0, 1], chunk 1 [1]; thread block 1:
    # its first chunk [1, 1]; thread block 2 is empty
    n_chunks = 3 * G
    start = [0, 3] + [4] * (G - 1) + [6] * G + [6] * G
    t = _block_tables([0, 0, 1, 1, 1, 1], start, n_chunks)
    st = chunk_staging(t)
    np.testing.assert_array_equal(st['blocks'], [4, 2, 0])
    np.testing.assert_array_equal(st['slots'], [2, 1, 0])
    np.testing.assert_array_equal(st['staged'], [True, True, True])
    # descriptors of 2 slots do not fit: 4 + 2 NT + 19 TF words a slot
    tf = (STAGE_WORDS // 2 - 4 - 2) // 19 + 1
    st = chunk_staging(_block_tables([0, 0, 1, 1, 1, 1], start, n_chunks,
                                     TF=tf))
    np.testing.assert_array_equal(st['staged'], [False, True, True])
    # a block list past STAGE_BLOCKS, one schedule per row of chunk_start
    n = STAGE_BLOCKS + 1
    st = chunk_staging(_block_tables(
        [5] * n + [6, 7], [[0] + [n] * (2 * G), [n] * (G + 1) + [n + 2] * G],
        2 * G))
    np.testing.assert_array_equal(st['blocks'], [[n, 0], [0, 2]])
    np.testing.assert_array_equal(st['slots'], [[1, 0], [0, 2]])
    np.testing.assert_array_equal(st['staged'], [[False, True],
                                                 [True, True]])


def test_tables_are_cached_per_device():
    _, _, _, _, low_t = lowered('vstack')
    plan = build_stack_plan(low_t)
    assert (build_stack_tables(plan, low_t, 'cpu')
            is build_stack_tables(plan, low_t, 'cpu'))


def test_stack_refuses_what_it_cannot_batch():
    from waveforms_tpu_torch import UnsupportedFactor
    low_t = lowered_from_jax(lower_j([wj.gaussian(2e-6) >> 4e-6], 0.0,
                                     8.192e-6, FS))
    assert build_stack_plan(low_t) is None
    with pytest.raises(UnsupportedFactor, match='batchable'):
        synthesize_stack(low_t, device='cpu')
    cx = lowered_from_jax(lower_j([(1 + 1j) * wj.cosPulse(5e-8)], 0.0,
                                  1e-6, FS, part='complex'))
    assert build_stack_plan(cx) is None



def test_first_plain_evaluation_in_fresh_processes():
    """The stack route's plain version on overlap_drag: its first
    evaluation in each of four fresh processes agrees with its second
    within TOL_JAX.  Each DRAG factor runs sin on the CPU, whose first
    call in a process can come out ~1e-4 off (ops/reference.py,
    warm_cpu_math)."""
    from waveforms_tpu_torch.cpu_first_call import run_children
    stats = run_children(['plain'] * 4, parallel=4)['plain']
    assert stats['processes'] == 4
    assert stats['worst_err'] <= TOL_JAX

_FIRST_SIN = r'''
import json, sys
import numpy as np
import torch
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.ops import StackSequencer, reference
from waveforms_tpu_torch.ops.hi_synth import HiSchedule
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                 build_stack_tables)
from waveforms_tpu_torch.ops.synth import DeviceSchedule

calls = []
sin = torch.sin
torch.sin = lambda x, *a, **k: calls.append(x.numel()) or sin(x, *a, **k)
chans = [wt.drag(100e6, 300e-9, plateau=200e-9, delta=2e6, block_freq=None,
                 phase=0.3, t0=0.0) >> 0.1e-6]
which = sys.argv[1]
low = lower_schedule(chans, 0.0, 1.1e-6, 2e9, keep_f64=which == 'hi')
if which == 'dense':
    d = DeviceSchedule(low, 'cpu')
    kernels.synth_dense.plain(d, torch.empty(1, low.n_samples), None)
elif which == 'hi':
    d = HiSchedule(low, 'cpu')
    kernels.synth_dense_hi.plain(d, torch.empty(1, low.n_samples,
                                                dtype=torch.float64), None)
elif which == 'stack':
    t = build_stack_tables(build_stack_plan(low), low, 'cpu')
    kernels.synth_stack.plain(t, torch.empty(1, low.n_samples), None)
else:
    seq = StackSequencer([low], device='cpu')
    ks = torch.zeros(2, dtype=torch.int32)
    kernels.synth_stack_seq.plain(seq.tables, ks,
                                  torch.empty(2, 1, low.n_samples), None)
print(json.dumps({'first': calls[0], 'warm': reference._WARM_ELEMENTS,
                  'calls': len(calls)}))
'''


@pytest.mark.parametrize('plain', ['dense', 'hi', 'stack', 'stack_seq'])
def test_first_sin_of_a_fresh_process_is_the_warm_up(plain):
    """In a fresh process, the first torch.sin that a plain version makes
    is warm_cpu_math's _WARM_ELEMENTS-sized call (a deterministic guard of
    the first-call repair: the fault itself shows only in some processes).
    The dense, double-tier, stack and stack-sequence plain versions each
    run a DRAG factor, whose envelope calls torch.sin."""
    import json
    import subprocess
    import sys
    r = subprocess.run([sys.executable, '-c', _FIRST_SIN, plain],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got['calls'] > 1
    assert got['first'] == got['warm']


def test_cpu_math_warms_again_when_the_thread_count_changes(monkeypatch):
    """warm_cpu_math runs once per intra-op thread count: a pool that grows
    after the first warm-up gets its new threads warmed too."""
    from waveforms_tpu_torch.ops import reference
    ran = []
    real_sin = torch.sin
    monkeypatch.setattr(torch, 'sin', lambda x: ran.append(x.numel())
                        or real_sin(x))
    threads = torch.get_num_threads()
    try:
        reference.warm_cpu_math()
        ran.clear()
        reference.warm_cpu_math()
        assert ran == []
        torch.set_num_threads(threads + 1)
        reference.warm_cpu_math()
        assert ran == [reference._WARM_ELEMENTS] * 2      # f32 and f64
        ran.clear()
        reference.warm_cpu_math()
        assert ran == []
    finally:
        torch.set_num_threads(threads)
