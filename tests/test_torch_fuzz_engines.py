"""The JAX suite's cross-engine fuzz (``tests/test_fuzz_engines.py``) held
against the port.

Every seed of the JAX file builds its random schedule twice: with the JAX
package's constructors (the JAX file's own ``random_channel``) and with the
port's (``schedules.fuzz_schedule``), and the two must be equal in the wire
format.  The port then runs it on ``device='cpu'`` (the kernels' plain
versions) on the JAX file's engines -- the host engine ``native``, the
routed kernel path, pair mode, the worklist kernel against the dense one,
the stack kernel -- each held to the JAX file's bound against the float64
oracle (5e-6 of each channel's peak) and against the JAX package's output
on the same seed: its ``native`` engine everywhere, and its Pallas kernel in
interpret mode on the seeds the JAX file runs that way.  Every routed call
runs under both routing rules (the ``rule`` fixture): the JAX package's and
the H100's (``ops.routes.CARD_RULE``), which a CUDA device takes.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import waveforms_tpu.native as native_j
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import synthesize_device as synth_j
from waveforms_tpu.ops.stack_synth import build_stack_plan as stack_plan_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import cross_engine, engine, native, schedules
from waveforms_tpu_torch.convert import waveform_from_jax
from waveforms_tpu_torch.ops import hi_synth, routes
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.stack_synth import build_stack_plan
from test_fuzz_engines import FS, SPAN, random_channel
from test_torch_synth import TOL_JAX

TOL = 5e-6          # the JAX file's bound, of each channel's peak

RULES = {'jax': routes.JAX_RULE, 'card': routes.CARD_RULE}


@pytest.fixture(params=list(RULES))
def rule(request, monkeypatch):
    """Pin the routers' rule whatever the device: the JAX package's or the
    H100's (on a CPU device ``rule_for`` gives the JAX package's)."""
    pinned = RULES[request.param]
    for mod in (engine, hi_synth, routes):
        monkeypatch.setattr(mod, 'rule_for', lambda device=None: pinned)
    return request.param


def jax_schedule(kind, seed):
    """The JAX file's draw for ``kind`` and its ``seed``-th seed, with the
    JAX package's constructors -> (channels, bucket_samples)."""
    base, _ = schedules.FUZZ_SEEDS[kind]
    rng = np.random.default_rng(base + seed)
    if kind == 'native':
        chans = [random_channel(rng) for _ in range(int(rng.integers(1, 5)))]
        bucket = int(rng.choice([0, 2048, 4096]))
        return chans, (bucket if bucket else None)
    if kind == 'complex':
        chans = [(rng.uniform(0.3, 1.0) + 1j * rng.uniform(0.3, 1.0))
                 * random_channel(rng) for _ in range(2)]
        for ch in chans:
            ch.max, ch.min = np.inf, -np.inf
        return chans, 'auto'
    chans = [random_channel(rng) for _ in range(2)]
    return chans, ('auto' if kind == 'stack' else 4096)


@lru_cache(maxsize=None)
def case(kind, seed):
    """(JAX channels, the port's channels, bucket_samples) of a seed."""
    chans_j, bucket = jax_schedule(kind, seed)
    chans_t, bucket_t = schedules.fuzz_schedule(kind, seed)
    assert bucket_t == bucket
    return chans_j, chans_t, bucket


@lru_cache(maxsize=None)
def oracle(kind, seed):
    """The float64 oracle of a seed's channels over the JAX file's grid
    (complex for the complex seeds, each stack's complex accumulation)."""
    chans_j, _, _ = case(kind, seed)
    t = np.arange(0, SPAN, 1 / FS)
    if kind == 'complex':
        return np.stack([np.asarray(
            (ch.simplify() if hasattr(ch, 'wlist') else ch)(t)).astype(
                complex) for ch in chans_j])
    return np.stack([np.asarray(ch(t), dtype=float) for ch in chans_j])


@lru_cache(maxsize=None)
def jax_native(kind, seed):
    chans_j, _, bucket = case(kind, seed)
    part = 'complex' if kind == 'complex' else 'real'
    low = lower_j(chans_j, 0, SPAN, FS, part=part,
                  bucket_samples=None if bucket is None else bucket)
    return native_j.synthesize_native(low)


def errs(out, want):
    """Each channel's max |out - want| over its peak (at least 1e-3, as the
    JAX file's ``oracle_and_errs``)."""
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return [float(np.abs(o - w).max() / max(np.abs(w).max(), 1e-3))
            for o, w in zip(out, want)]


def held(out, kind, seed, label):
    """``out`` within TOL of the oracle and of JAX's native engine."""
    e_ora = errs(out, oracle(kind, seed))
    e_jax = errs(out, jax_native(kind, seed))
    assert max(e_ora) < TOL, f"{label} seed {seed}: vs oracle {e_ora}"
    assert max(e_jax) < TOL, f"{label} seed {seed}: vs JAX native {e_jax}"


SEEDS = [(kind, seed) for kind, (_, n) in schedules.FUZZ_SEEDS.items()
         for seed in range(n)]


@pytest.mark.parametrize('kind, seed', SEEDS)
def test_fuzz_schedule_is_the_jax_one(kind, seed):
    """The port's constructors draw the JAX file's schedule from its seed:
    equal in the wire format, channel for channel."""
    chans_j, chans_t, _ = case(kind, seed)
    assert len(chans_t) == len(chans_j)
    for w_t, w_j in zip(chans_t, chans_j):
        assert type(w_t).__name__ == type(w_j).__name__
        assert w_t.tolist() == waveform_from_jax(w_j).tolist()


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_native_vs_oracle(seed):
    """The port's host engine: within TOL of the oracle, and bit-equal to
    the JAX package's ``native`` on the same lowering."""
    _, chans, bucket = case('native', seed)
    low = lower_schedule(chans, 0, SPAN, FS, bucket_samples=bucket)
    out = native.synthesize_native(low)
    assert max(errs(out, oracle('native', seed))) < TOL
    np.testing.assert_array_equal(out, jax_native('native', seed))


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_routed_vs_oracle(seed, rule):
    """``engine='auto'`` on the native seeds, under each rule."""
    _, chans, bucket = case('native', seed)
    out = wt.synthesize(chans, 0, SPAN, FS, bucket_samples=bucket,
                        device='cpu')
    assert out.dtype == torch.float32
    held(out, 'native', seed, f'auto ({rule})')


@lru_cache(maxsize=None)
def jax_kernel(seed):
    """The JAX file's Pallas run of a kernel seed, in interpret mode."""
    chans_j, _, _ = case('kernel', seed)
    low = lower_j(chans_j, 0, SPAN, FS, bucket_samples=4096)
    return np.asarray(synth_j(DeviceJ(low), rows_per_tile=8,
                              interpret=True))


@pytest.mark.parametrize('seed', range(2))
def test_fuzz_kernel_vs_oracle(seed, rule):
    """The routed kernel path and the forced dense kernel on the JAX file's
    Pallas seeds: within TOL of the oracle and of JAX's native engine, and
    within TOL_JAX of JAX's kernel in interpret mode."""
    _, chans, bucket = case('kernel', seed)
    want = jax_kernel(seed)
    assert max(errs(want, oracle('kernel', seed))) < TOL
    for eng in ('auto', 'cuda-dense'):
        out = wt.synthesize(chans, 0, SPAN, FS, engine=eng,
                            bucket_samples=bucket, device='cpu')
        held(out, 'kernel', seed, f'{eng} ({rule})')
        assert max(errs(out, want)) <= TOL_JAX, eng


@pytest.mark.parametrize('seed', range(2))
def test_fuzz_complex_pair(seed, rule):
    """Random complex amplitudes: the host engine and pair mode (complex64
    from one pass), routed and on the dense kernel, against the complex
    oracle."""
    _, chans, _ = case('complex', seed)
    low = lower_schedule(chans, 0, SPAN, FS, part='complex')
    out = native.synthesize_native(low)
    assert max(errs(out, oracle('complex', seed))) < TOL
    np.testing.assert_array_equal(out, jax_native('complex', seed))
    for eng in ('auto', 'cuda-dense'):
        out = wt.synthesize(chans, 0, SPAN, FS, engine=eng, part='complex',
                            device='cpu')
        assert out.dtype == torch.complex64
        held(out, 'complex', seed, f'{eng} pair ({rule})')


@pytest.mark.parametrize('seed', range(3))
def test_fuzz_sparse_vs_dense(seed):
    """The worklist kernel equals the dense kernel bit for bit (both plain
    versions walk the same segments), and both hold TOL."""
    _, chans, bucket = case('sparse', seed)
    dense = wt.synthesize(chans, 0, SPAN, FS, engine='cuda-dense',
                          bucket_samples=bucket, device='cpu')
    sparse = wt.synthesize(chans, 0, SPAN, FS, engine='cuda-sparse',
                           bucket_samples=bucket, device='cpu')
    assert torch.equal(sparse, dense)
    held(dense, 'sparse', seed, 'cuda-dense')


@pytest.mark.parametrize('seed', range(4))
def test_fuzz_stack_vs_oracle(seed, rule):
    """The stack kernel where the JAX package plans the seed's instances
    (the port's plan exists exactly where JAX's does), and the routed path
    in every case, within TOL."""
    chans_j, chans, _ = case('stack', seed)
    low = lower_schedule(chans, 0, SPAN, FS)
    plan = build_stack_plan(low)
    assert (plan is None) == (stack_plan_j(lower_j(chans_j, 0, SPAN, FS))
                              is None)
    if plan is not None:
        out = wt.synthesize(chans, 0, SPAN, FS, engine='cuda-stack',
                            device='cpu')
        held(out, 'stack', seed, 'cuda-stack')
    out = wt.synthesize(chans, 0, SPAN, FS, device='cpu')
    held(out, 'stack', seed, f'auto ({rule})')


@pytest.mark.parametrize('case', cross_engine.CASES)
def test_cross_engine_checks_on_the_cpu(case, rule):
    """``cross_engine``'s checks, which the card runs
    (``tests/test_torch_cuda_fuzz.py``, ``chip_smoke.py``), on CPU tensors
    under each rule: every route's plain version within the card's bounds
    of the oracle (the double tier's clipped at f32 rails), a refusal the
    same on both sides."""
    for c, mode, eng in cross_engine.checks((case,)):
        rec = cross_engine.check(c, mode, eng, device='cpu')
        assert rec['ok'], rec
