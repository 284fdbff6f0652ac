"""The measurement probes' plain versions against the JAX probe kernels.

``waveforms_tpu_torch.probes`` run with ``device='cpu'`` gives the plain
versions' outputs (``ops/reference_probes.py``, the plain versions of
``csrc/probes.cu``), which are held to the TPU probes of
``tools/tpu_capture.py``:

- P2 and P3: the unchanged ``task_grid_overhead_probe`` and
  ``task_walker_cost_probe``, with ``pallas_call`` in interpret mode and
  their profiler timing replaced by a call that keeps each variant's
  output.  Every variant must equal the port's bit for bit (both are f32
  add chains in one order).
- P1: the compact worklist output against the JAX worklist kernel
  (``_run_sparse``, interpret mode) gathered per worklist item, within
  1e-6 of each channel's peak (the two walks round their f32 sums in
  different orders), on ``_sparse_chans(8)`` over 32.768 us; the padded
  worklist gives the unpadded output.
- P4: ``2 * x`` exactly.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.sparse_synth import _run_sparse
from waveforms_tpu.ops.sparse_synth import build_sparse_plan as plan_j
from waveforms_tpu_torch import kernels, probes
from waveforms_tpu_torch.ops.reference_probes import WALKER_BODIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import tpu_capture  # noqa: E402  (tools/ is not a package)

TOL_JAX = 1e-6
SPARSE_STOP = 32.768e-6


def _jax_probe_outputs(task):
    """Run a tpu_capture task with pallas_call in interpret mode, keeping
    the output of every variant it would have timed, in order."""
    kept = []
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        return real(*args, **dict(kwargs, interpret=True))

    def keep(run, prefix, *args, **kwargs):
        kept.append(np.asarray(run()))
        return 1e-6

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, 'pallas_call', interpreted)
        mp.setattr(tpu_capture, 'profile_median', keep)
        mp.setattr(tpu_capture, '_measure', keep)
        task()
    return kept


@pytest.fixture(scope='module')
def jax_grid():
    return dict(zip(probes.GRID_VARIANTS,
                    _jax_probe_outputs(tpu_capture.task_grid_overhead_probe)))


@pytest.fixture(scope='module')
def jax_walker():
    return dict(zip([b for b, _ in WALKER_BODIES],
                    _jax_probe_outputs(tpu_capture.task_walker_cost_probe)))


@pytest.fixture(scope='module')
def port_grid():
    return probes.grid_overhead_probe('cpu')['outputs']


@pytest.fixture(scope='module')
def port_walker():
    return probes.walker_cost_probe('cpu')['outputs']


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize('variant', list(probes.GRID_VARIANTS))
def test_grid_probe_matches_jax_bit_for_bit(variant, jax_grid, port_grid):
    ref, got = jax_grid[variant], port_grid[variant].numpy()
    assert got.shape == ref.shape == ((256 if 'dynout' in variant else 4096),
                                      32, 128)
    assert np.array_equal(_bits(got), _bits(ref))
    n_ops = probes.GRID_VARIANTS[variant][0]
    assert (got == sum(range(n_ops))).all()        # 78.0 or 1.0


@pytest.mark.parametrize('body', [b for b, _ in WALKER_BODIES])
def test_walker_probe_matches_jax_bit_for_bit(body, jax_walker, port_walker):
    ref, got = jax_walker[body], port_walker[body].numpy()
    assert got.shape == ref.shape == (2048, 32, 128)
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.isfinite(got).all() and np.abs(got).max() > 0


@pytest.fixture(scope='module')
def sparse_port():
    return probes.sparse_step_cost_probe('cpu', n_channels=8,
                                         stop=SPARSE_STOP)


def test_sparse_compact_matches_jax_worklist_kernel(sparse_port):
    low = lower_j(tpu_capture._sparse_chans(8), 0.0, SPARSE_STOP,
                  tpu_capture.FS)
    dev = DeviceJ(low)
    plan = plan_j(low, Rs=32)
    C, NB, S, T, F = dev.shape
    work = [plan.work_c, plan.work_b, plan.work_t, plan.work_o,
            plan.work_s0, plan.work_s1]
    ref = np.asarray(_run_sparse(
        *[jnp.asarray(w) for w in work], *dev.tensors[:2], *dev.tensors[3:],
        None, None, S=S, T=T, F=F, Rs=32, n_tiles=plan.n_tiles,
        ops_present=dev.ops_present, interpret=True))
    ref = ref.reshape(C, plan.n_tiles + 1, 32 * 128)
    K = len(plan.work_c)
    assert (sparse_port['n_live'], sparse_port['K']) == (plan.n_live, K)
    got = sparse_port['outputs']['compact'].numpy().reshape(K, -1)
    want = ref[plan.work_c, plan.work_o]
    peak = np.abs(ref).reshape(C, -1).max(axis=1)[plan.work_c]
    err = np.abs(got - want).max(axis=1) / np.maximum(peak, 1e-30)
    assert err.max() <= TOL_JAX
    assert np.abs(want).max() > 0
    assert (got[plan.n_live:] == 0).all()          # padding items


def test_padded_worklist_gives_the_same_output(sparse_port):
    """Padding items (work_t = work_o = n_tiles) store nothing in the
    worklist kernel and zeros in the compact variant."""
    out = sparse_port['outputs']
    K = sparse_port['K']
    assert torch.equal(out['aliased_pad4'], out['aliased'])
    assert torch.equal(out['compact_pad4'][:K], out['compact'])
    assert (out['compact_pad4'][K:] == 0).all()
    # the compact blocks are the worklist kernel's subtiles
    inp = probes.sparse_inputs(8, SPARSE_STOP, 'cpu')
    plan = inp['plan']
    tile = plan.Rs * 128
    for k in range(plan.n_live):
        c, o = plan.work_c[k], plan.work_o[k]
        assert torch.equal(out['compact'][k].reshape(-1),
                           out['aliased'][c, o * tile:(o + 1) * tile])


def test_health_probe_doubles():
    res = probes.health_probe('cpu')
    assert res['ok'] and res['value'] == 2.0
    x = torch.linspace(-3, 3, 8 * 128).reshape(8, 128)
    y = kernels.probe_health(x, torch.empty_like(x))
    assert torch.equal(y, x * 2)


def test_probe_wrappers_run_their_plain_versions_on_the_cpu():
    kernels.reset_launch_counts()
    probes.health_probe('cpu')
    probes.grid_overhead_probe('cpu', K=64)
    probes.walker_cost_probe('cpu', K=64)
    probes.sparse_step_cost_probe('cpu', n_channels=2, stop=SPARSE_STOP)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize('probe', [probes.health_probe,
                                   probes.sparse_step_cost_probe,
                                   probes.grid_overhead_probe,
                                   probes.walker_cost_probe])
def test_probes_default_to_the_card(probe, monkeypatch):
    assert inspect.signature(probe).parameters['device'].default == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        probe()


def test_probes_module_imports_no_jax():
    code = ("import sys; import waveforms_tpu_torch.probes; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'waveforms_tpu.')) "
            "or m == 'waveforms_tpu']; print(bad); assert not bad, bad")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


def test_probe_wrappers_refuse_bad_shapes():
    inp = probes.grid_inputs(8, 'cpu')
    with pytest.raises(ValueError, match='2 or 13'):
        kernels._launch_probe_grid(inp['tables'], inp['wc'], inp['wo'], 5,
                                   True, False, torch.zeros((8, 32, 128)))
    with pytest.raises(ValueError, match='static output map'):
        kernels._launch_probe_grid(inp['tables'], inp['wc'], inp['wo'], 13,
                                   True, False, torch.zeros((4, 32, 128)))
    w = probes.walker_inputs(8, 'cpu')
    with pytest.raises(ValueError, match='unknown walker body'):
        kernels._launch_probe_walker('nope', w['wc'], w['ftab'], w['itab'],
                                     torch.zeros((8, 32, 128)))
    with pytest.raises(ValueError, match=r'\(n_blocks, Rs, 128\)'):
        kernels._launch_probe_walker('base', w['wc'], w['ftab'], w['itab'],
                                     torch.zeros((8, 4096)))
