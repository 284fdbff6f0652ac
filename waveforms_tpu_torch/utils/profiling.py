"""Profiling hooks on ``torch.profiler``: trace a synthesis call, read its
device time.

The port of ``waveforms_tpu.utils.profiling`` with its four names:
:func:`trace` writes a Chrome trace (TensorBoard's PyTorch profiler plugin
reads it) of everything inside it, :func:`annotate` names a region in it,
:func:`device_event_times` reads the card's kernel durations back out of
it, and :func:`measure_device` times one function's kernels on the card.
:func:`device_events` is the reader under all of them.

Device time here is the card's own record of each kernel (CUPTI, through
Kineto), not a host clock: a process without a CUDA device has no such
record, and :func:`measure_device` raises there.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import shutil
import socket
import statistics
import tempfile
import time

__all__ = ['trace', 'annotate', 'device_events', 'device_event_times',
           'measure_device', 'kernel_name', 'KERNELS', 'COPIES', 'ATTEMPTS']

# Kineto's categories of the events on a GPU's timeline
KERNELS = ('kernel',)
COPIES = ('gpu_memcpy', 'gpu_memset')
# A trace can miss kernels (``tools/trace_capture.py`` counts them): on an
# NVIDIA H100 80GB HBM3, in a process that had run a while on the card or
# after other processes had used it, the first records of a trace -- up to
# all of them -- often went unrecorded, and the card's timestamps stood up
# to ~1 ms off the host's.  A trace therefore opens with LEAD_KERNELS empty
# launches (``torch.cuda._sleep(0)``'s spin kernel, which the readers skip)
# and LEAD_S seconds on a drained queue, and stays on TAIL_S seconds past
# the drained queue at its end; measure_device traces again, up to
# ATTEMPTS times, where a trace holds none of the kernels it looks for.
LEAD_KERNELS = 20
LEAD_S = 0.05
TAIL_S = 0.01
ATTEMPTS = 3
LEAD_NAME = 'spin_kernel'
_QUALIFIERS = re.compile(r'(?:void )?(?:(?:\w+|\(anonymous namespace\))::)*')


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: profile everything inside to *log_dir*.

    ``torch.profiler.profile`` with the CPU activity, and the CUDA activity
    where the process has a card; there it opens with :data:`LEAD_KERNELS`
    empty launches and :data:`LEAD_S` seconds, and on exit waits for the
    card's queue to drain and :data:`TAIL_S` more (a trace's first and last
    kernels can lose their records otherwise), and writes the Chrome trace JSON into
    *log_dir* under the name ``torch.profiler.tensorboard_trace_handler``
    gives it, ``<host>_<pid>.<ns>.pt.trace.json``.

    >>> with trace('wf-trace'):                      # doctest: +SKIP
    ...     out = synthesize(channels, 0, 1e-3, 2e9)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(LEAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TAIL_S)
    prof.export_chrome_trace(os.path.join(
        log_dir, f'{socket.gethostname()}_{os.getpid()}.{time.time_ns()}'
        '.pt.trace.json'))


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in the profiler timeline
    (``torch.profiler.record_function``: a ``user_annotation`` span on the
    host's timeline, and one on the card's over the kernels it launched)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


def _device_pids(events) -> set:
    """The pids of the GPU timelines: Kineto labels each GPU's process
    ``GPU <index>`` (``process_labels``), the host's ``CPU``."""
    return {e.get('pid') for e in events
            if e.get('ph') == 'M'
            and e.get('name') in ('process_name', 'process_labels')
            and str((e.get('args') or {}).get(
                'name', (e.get('args') or {}).get('labels', '')))
            .startswith('GPU')}


def device_events(log_dir: str, cats=KERNELS) -> list[dict]:
    """The complete events (``'ph': 'X'``) of a category in *cats* on a GPU
    timeline, from every trace :func:`trace` wrote under *log_dir*, in the
    order they started: Kineto's dicts, ``'name'``, ``'cat'``, ``'ts'`` and
    ``'dur'`` (microseconds) among their keys.  *cats* is :data:`KERNELS`
    by default; :data:`COPIES` adds the memory copies and fills.  Host
    spans -- operators, runtime calls, annotations -- are on the host's
    timeline and never among them, nor are the lead's launches (kernels
    named :data:`LEAD_NAME`, ``torch.cuda._sleep``'s)."""
    out: list[dict] = []
    for path in sorted(glob.glob(os.path.join(log_dir,
                                              '*.pt.trace.json*'))):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt') as f:
            events = json.load(f).get('traceEvents', [])
        pids = _device_pids(events)
        out.extend(e for e in events
                   if e.get('ph') == 'X' and e.get('cat') in cats
                   and e.get('pid') in pids and not kernel_name(
                       e.get('name', '')).startswith(LEAD_NAME))
    return sorted(out, key=lambda e: e['ts'])


def kernel_name(name: str) -> str:
    """A kernel event's name as :func:`device_event_times` matches a prefix
    against it: the demangled C++ name that the trace gives without the
    return type and the namespaces in front of the function's name
    (``'void wfsynth::synth_dense_kernel<false, 4, false>(wfsynth::Desc,
    ...)'`` -> ``'synth_dense_kernel<false, 4, false>(wfsynth::Desc,
    ...)'``)."""
    return _QUALIFIERS.sub('', name, count=1)


def device_event_times(log_dir: str, name_prefix: str) -> list[float]:
    """Durations (seconds) of the card's kernels whose names start with
    *name_prefix*, from the Chrome traces a :func:`trace` capture wrote
    under *log_dir*.

    Only kernel events on a GPU timeline count (Kineto's ``"cat":
    "kernel"`` on a GPU's pid), as the JAX version keeps only a TPU's
    timeline: host-side launch and operator spans are excluded.  A name is
    matched by :func:`kernel_name`: the kernel's own name, template
    arguments and signature after it, so ``'synth_dense_kernel'`` selects
    the dense kernel K1 and not ``synth_dense_hi_kernel`` (K3), and
    ``'iir_'`` every kernel of S1.
    """
    return [e['dur'] / 1e6 for e in device_events(log_dir)
            if kernel_name(e.get('name', '')).startswith(name_prefix)]


def measure_device(fn, name_prefix: str, reps: int = 3,
                   log_dir: str | None = None) -> float:
    """Median device-side duration (seconds) of the kernels that ``fn()``
    launches whose names start with *name_prefix* (as
    :func:`device_event_times` matches them), over *reps* calls traced
    together.

    Each matching kernel is one sample: a call that launches it twice
    gives two.  A trace that loses a kernel's record (:func:`trace`'s lead
    and tail guard its edges) loses one sample, and the median of the
    others stands; a trace that holds no matching event is taken again, up
    to :data:`ATTEMPTS` traces of *reps* calls.  Warm ``fn`` up first where
    its first call builds the kernels.  The trace goes to *log_dir*,
    emptied before each attempt, or to a temporary directory removed
    afterwards.  Raises ``RuntimeError`` if no trace holds a matching
    device event -- always in a process without a CUDA device: there is
    no host clock to fall back to.
    """
    import torch

    own = log_dir is None
    where = tempfile.mkdtemp(prefix='wftpu_torch_measure_') if own else str(
        log_dir)
    times: list[float] = []
    try:
        for _ in range(ATTEMPTS if torch.cuda.is_available() else 1):
            shutil.rmtree(where, ignore_errors=True)
            with trace(where):
                for _ in range(reps):
                    fn()
            times = device_event_times(where, name_prefix)
            if times:
                break
    finally:
        if own:
            shutil.rmtree(where, ignore_errors=True)
    if not times:
        raise RuntimeError(
            f"no device events matching '{name_prefix}' in {where}")
    return statistics.median(times)
