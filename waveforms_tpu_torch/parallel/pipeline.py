"""The production shot flow: synthesize -> predistort -> demodulate.

The port of the JAX package's ``waveforms_tpu/parallel/pipeline.py``.
:func:`make_step` builds the sharded production step over a device mesh
(:mod:`.mesh`): the dense kernel K1 on every shard, the per-channel (b, a)
pre-compensation IIR (:func:`..ops.iir.lfilter`: the recurrence kernel S1
on the card, JAX's route on CPU shards) on every shard, its state carried
from each time shard to the next, and readout demodulation against a tone
comb (:func:`..ops.demod.demodulate`) with the time shards' partial sums
added on one device, JAX's psum.  :func:`run_step` lowers and runs one such step.
:func:`run_sequence` plays a shot table through a
:class:`~waveforms_tpu_torch.ops.Sequencer` (K1's shot entry for each shot)
on one device through the same filter and demodulation: on the card as one
CUDA graph a shot (:class:`SequenceGraph`), JAX's ``jit`` of a
``lax.scan``, kept on the Sequencer for the next call with the same key;
its plain version, the host loop, is :func:`run_sequence_loop`.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..utils.profiling import annotate

__all__ = ['make_step', 'run_step', 'run_sequence', 'run_sequence_loop',
           'SequenceGraph', 'PROGRAMS_KEPT']


def _postfilter_coeffs(ba_filters):
    """The combined (b, a) cascade and its lfiltic zero-history initial
    state (numpy), or None."""
    if not ba_filters:
        return None
    from scipy.signal import lfiltic

    from ..distortion import combine_filters
    b, a = combine_filters(ba_filters)
    return b, a, lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))


def _make_postfilter(ba_filters, device, n):
    """Shared (b, a)-cascade pre-compensation closure (or None) over
    signals of ``n`` samples a row: the lfiltic zero-history initial state
    and the device lfilter over every row, in float64, its constants put on
    ``device`` once (:func:`..ops.iir._lfilter_apply`).

    The JAX package runs this filter in the synthesized signal's f32, with
    a float64 result.  For a combined cascade with near-unit poles that is
    not accurate: with the station's Z-settle pair (poles 1 - 2.5e-5 and
    1 - 1.7e-4, d = 2) its shots of 4096 samples are 0.11 of the peak off
    scipy (``tests/test_torch_streaming.py``).  The port filters in f64,
    as the streaming path does."""
    coeffs = _postfilter_coeffs(ba_filters)
    if coeffs is None:
        return None
    from ..ops.iir import _lfilter_apply
    filt = _lfilter_apply(*coeffs, n, torch.empty(
        (), dtype=torch.float64, device=device))

    def apply(sig):
        return filt(sig.double())[0]

    return apply


def _runs(owners) -> list:
    """A row's time shards grouped into runs of one owner, in order ->
    [(owner, [j, ...]), ...]."""
    runs = []
    for j, o in enumerate(int(o) for o in owners):
        if runs and runs[-1][0] == o:
            runs[-1][1].append(j)
        else:
            runs.append((o, [j]))
    return runs


def _shard_runs(owners) -> list:
    """Every time shard a run of its own: the carry that crosses processes,
    between every two shards, in one process (the tests' way to hold it
    there)."""
    return [(int(o), [j]) for j, o in enumerate(owners)]


def make_step(low, mesh, ba_filters=None, demod_freqs=None,
              rows_per_tile: int | None = None):
    """Build the sharded production step for a lowered schedule.

    ``ba_filters``: list of (b, a) pre-compensation filters (combined and
    applied per channel).  ``demod_freqs``: tone frequencies for readout
    demodulation (None skips it).  Returns ``step() -> (signals, iq)``:
    ``signals`` a :class:`.mesh.ShardedPlane` (f32 from
    :func:`.mesh.synthesize_sharded`, float64 when filtered) and ``iq`` the
    (C, n_tones) complex64 IQ points on the mesh's first device (on a mesh
    that spans processes, every rank's first local device), or None.

    The filter runs on each shard's block in float64 (as
    :func:`run_sequence`'s; the JAX package filters in f32), from the
    state that the row's samples before the shard leave: scipy's recurrence
    over the whole row, by the route that :func:`..ops.iir.lfilter` takes
    for the whole row (JAX filters the global array), whatever the shard's
    length.  A row's time shards fall into runs, each of one process's
    shards in a row; within a run each shard starts from the final state
    of the one before it.  Across runs the state is carried in parallel,
    as XLA's associative scan carries it: (a) each run but a row's last
    takes its end state from a zero state, its shards' final states alone
    one after another (:func:`..ops.iir.lfilter_zf`: S1's state-only call,
    or, on a CPU shard whose row JAX routes to the doubling scan, the
    scan's own final state); (b) one all-gather of those
    (C, d) boundary states; (c) each run's start state from the runs
    before it by :func:`..ops.iir.shard_carry` (Phi(n) z + zf0), and its
    shards filtered from it.  No process waits on another's filter.  Where
    no row crosses processes (every mesh in one process, and JAX's layout)
    a row is one run: no state-only call, no exchange, and the shards run
    one after another.

    Each time shard demodulates its block against its rows of the
    ``demod_matrix`` (JAX shards the matrix ``P('time', None)``), and the
    partial sums are added: on the first device in one process, by a sum
    over the processes of a (C, n_tones) tensor where the mesh spans them.
    Between processes the step sends the boundary states and the IQ points
    and never a signal-sized tensor (``distributed.SENT``)."""
    return _make_step(low, mesh, ba_filters, demod_freqs, rows_per_tile,
                      _runs)


def _make_step(low, mesh, ba_filters, demod_freqs, rows_per_tile, runs_of):
    """:func:`make_step` with each row's runs of shards from ``runs_of``
    (a row's owners -> [(owner, [j, ...]), ...])."""
    from ..ops.demod import demod_matrix, demodulate
    from ..ops.iir import lfilter, lfilter_zf, shard_carry, state_maps
    from . import distributed
    from .mesh import ShardedPlane, synthesize_sharded
    local = mesh.local
    if not local:
        raise ValueError("this process owns no shard of the mesh")
    home = mesh.device(*local[0])
    n_row = low.n_samples          # every shard takes its whole row's route
    coeffs = _postfilter_coeffs(ba_filters)
    demod = None
    if demod_freqs is not None:
        demod = demod_matrix(demod_freqs, low.n_samples, low.sample_rate,
                             device='cpu')
    rows_on = {}                 # (first sample, device) -> demod rows
    maps = {}                    # the carry's state maps, built once

    def demod_rows(a, b, device):
        key = (a, str(device))
        if key not in rows_on:
            rows_on[key] = demod[a:b].to(device)
        return rows_on[key]

    def filtered(plane):
        b, a, zi0 = coeffs
        d = len(zi0)
        nc, nt = mesh.devices.shape
        widths = [w for _, w in plane.block_shapes[0]]
        keep = [s[0][0] for s in plane.block_shapes]
        runs = [runs_of(mesh.owners[i]) for i in range(nc)]
        lengths = [[sum(widths[j] for j in js) for _, js in row]
                   for row in runs]
        mine = [[k for k, (o, _) in enumerate(row) if o == mesh.rank]
                for row in runs]
        # (a) the end state from zero of each local run but a row's last
        run_end = {}
        for i in range(nc):
            for k in mine[i]:
                if k == len(runs[i]) - 1:
                    continue
                js = runs[i][k][1]
                z = torch.zeros((keep[i], d), dtype=torch.float64,
                                device=mesh.device(i, js[0]))
                for j in js:
                    block = plane.blocks[i][j]
                    if block.shape[1]:
                        z = lfilter_zf(b, a, block.double(), n_row,
                                       zi=z.to(block.device))
                run_end[i, k] = z
        # (b) one all-gather of those boundary states, one a run
        slots = [[(i, k) for i in range(nc)
                  for k, (o, _) in enumerate(runs[i][:-1]) if o == r]
                 for r in range(distributed.world_size())]
        m, cs = max(len(s) for s in slots), max(keep)
        if m and mesh.spans_processes:
            mine_end = torch.zeros((m, cs, d), dtype=torch.float64,
                                   device=home)
            for q, (i, k) in enumerate(slots[mesh.rank]):
                mine_end[q, :keep[i]] = run_end[i, k].to(home)
            for r, got in enumerate(distributed.all_gather(mine_end)):
                for q, (i, k) in enumerate(slots[r]):
                    if r != mesh.rank:
                        run_end[i, k] = got[q, :keep[i]]
        # (c) each local run's start state from the runs before it, and
        # its shards filtered one after another from it
        rows = [[None] * nt for _ in range(nc)]
        for i in sorted({i for i, _ in local}):
            dev = mesh.device(i, runs[i][mine[i][0]][1][0])
            zi = torch.as_tensor(zi0).to(dev).expand(keep[i], d)
            last = max(mine[i])
            starts = zi[:, None]
            if last:
                if not maps:
                    maps.update(state_maps(b, a, [
                        n for row in lengths for n in row[:-1]]))
                ends = [run_end[i, k].to(dev) for k in range(last)]
                starts = shard_carry(
                    b, a, torch.stack(ends + [torch.zeros_like(ends[0])], 1),
                    lengths[i][:last] + [0], zi, maps)
            for k in mine[i]:
                z = starts[:, k]
                for j in runs[i][k][1]:
                    block = plane.blocks[i][j].double()
                    if block.shape[1]:
                        block, z = lfilter(b, a, block, zi=z.to(
                            block.device), route_n=n_row)
                    rows[i][j] = block
        return rows

    def step():
        plane = synthesize_sharded(low, mesh, rows_per_tile=rows_per_tile)
        if coeffs is not None:
            plane = ShardedPlane(filtered(plane), plane.shape, torch.float64,
                                 plane.owners, plane.block_shapes)
        iq = None
        if demod is not None:
            iq = torch.zeros((low.shape[0], len(demod_freqs)),
                             dtype=torch.complex64, device=home)
            cs = max(s[0][0] for s in plane.block_shapes)
            for i, row in enumerate(plane.blocks):
                acc, s0 = None, 0
                for block, (_, n) in zip(row, plane.block_shapes[i]):
                    if block is not None and n:
                        p = demodulate(block, demod_rows(
                            s0, s0 + n, block.device)).to(home)
                        acc = p if acc is None else acc + p
                    s0 += n
                if acc is not None:
                    iq[i * cs:i * cs + acc.shape[0]] = acc
            if mesh.spans_processes:
                iq = distributed.all_reduce_sum(iq)
        return plane, iq

    return step


def run_step(channels, start, stop, sample_rate, mesh, ba_filters=None,
             demod_freqs=None, **kw):
    """Lower, build and run one sharded production step (:func:`make_step`)
    -> (signals, iq)."""
    from ..ops.lowering import lower_schedule
    low = lower_schedule(channels, start, stop, sample_rate)
    return make_step(low, mesh, ba_filters=ba_filters,
                     demod_freqs=demod_freqs, **kw)()


def _shot_body(seq, ba_filters, demod_freqs, rows_per_tile):
    """One shot of :func:`run_sequence`: ``one(k)`` plays schedule ``k``
    (an int or a 0-d tensor) through K1's shot entry, the optional
    pre-compensation IIR in float64 and the demodulation, with every
    constant already on the table's device (made in the span
    ``wf.sequence.constants``)."""
    with annotate('wf.sequence.constants'):
        filt = _make_postfilter(ba_filters, seq.device, seq.n_samples)
        demod = None
        if demod_freqs is not None:
            from ..ops.demod import demod_matrix, demodulate
            demod = demod_matrix(demod_freqs, seq.n_samples,
                                 seq.sample_rate, device=seq.device)

    def one(k):
        sig = seq.play(k, rows_per_tile=rows_per_tile)
        if filt is not None:
            sig = filt(sig)
        return demodulate(sig, demod) if demod is not None else sig

    return one


#: shot programs a Sequencer keeps for :func:`run_sequence`
PROGRAMS_KEPT = 4


def _program_key(ba_filters, demod_freqs, rows_per_tile, n_shots):
    """What :func:`run_sequence`'s shot program is built from or reads, by
    value: the shot count, the filters' coefficients, the tones,
    ``rows_per_tile`` and the post-filter builder in force."""
    filters = tuple((np.asarray(b, np.float64).tobytes(),
                     np.asarray(a, np.float64).tobytes())
                    for b, a in ba_filters or ())
    tones = None if demod_freqs is None else tuple(
        float(f) for f in np.atleast_1d(np.asarray(demod_freqs, float)))
    return n_shots, filters, tones, rows_per_tile, _make_postfilter


def _kept(seq, key, build, renew=None):
    """The shot program ``seq`` keeps under ``key``, ``renew``-ed in the
    span ``wf.sequence.reuse`` (a hit), or ``build()``'s, kept in its
    place (a miss), with the least recently used past
    :data:`PROGRAMS_KEPT` released.  The caller holds
    ``seq._shot_programs_lock``."""
    programs = seq._shot_programs
    program = programs.get(key)
    if program is not None:
        with annotate('wf.sequence.reuse'):
            programs.move_to_end(key)
            seq.graph_hits += 1
            if renew is not None:
                renew(program)
        return program
    seq.graph_misses += 1
    program = programs[key] = build()
    while len(programs) > PROGRAMS_KEPT:
        _, old = programs.popitem(last=False)
        if isinstance(old, SequenceGraph):
            old.release()
    return program


def run_sequence(seq, indices, ba_filters=None, demod_freqs=None,
                 rows_per_tile: int | None = None) -> torch.Tensor:
    """Run a shot table through a
    :class:`~waveforms_tpu_torch.ops.Sequencer`, on its device.

    ``indices`` is the per-shot schedule-index vector (a list, an array or
    a 1-D tensor; length = number of shots; e.g. a randomized-benchmarking
    order, clamped to the table as ``Sequencer.play`` clamps it).  Each
    shot synthesizes via ``seq.play`` (K1's shot entry), applies the
    optional pre-compensation IIR in float64 and demodulates against the
    tone comb; only each shot's result is kept, so memory stays bounded at
    one shot's signal regardless of shot count.

    On a CUDA device the shot is one captured program, as JAX's ``jit`` of
    a ``lax.scan`` is: a :class:`SequenceGraph`, captured once a key and
    kept on the Sequencer, replayed once a shot, which reads the shot's
    index on the card (a CUDA ``indices`` is never read on the host).  The
    key is the shot count, the filters' coefficients, the tones,
    ``rows_per_tile`` and the post-filter builder in force; a later call
    with the same key copies its indices into the kept graph and replays
    it, and a call on another stream than the last waits for the last.
    The Sequencer keeps :data:`PROGRAMS_KEPT` programs, the least recently
    used out first, and calls from threads that share it take turns
    (``graph_hits`` and ``graph_misses`` count its lookups).  A capture
    that fails raises.  On the CPU the Sequencer keeps the shot body under
    the same key and runs the host loop, whose plain version is
    :func:`run_sequence_loop`; both give the same bits.

    Returns a fresh tensor: ``iq`` of shape (n_shots, C, n_tones)
    complex64 when ``demod_freqs`` is given, otherwise the stacked signals
    (n_shots, C, N): f32, or float64 when filtered.
    """
    if seq.device.type != 'cuda':
        ks = _host_indices(indices)
        key = _program_key(ba_filters, demod_freqs, rows_per_tile, len(ks))
        with seq._shot_programs_lock:
            one = _kept(seq, key, lambda: _shot_body(
                weakref.proxy(seq), ba_filters, demod_freqs, rows_per_tile))
        return _host_loop(one, ks)
    with annotate('wf.sequence.constants'):
        ks = seq.shot_indices(indices)
    key = _program_key(ba_filters, demod_freqs, rows_per_tile, ks.shape[0])
    with seq._shot_programs_lock:
        # the kept graph holds the Sequencer weakly: the Sequencer holds it
        graph = _kept(seq, key, lambda: SequenceGraph(
            weakref.proxy(seq), ks, ba_filters, demod_freqs, rows_per_tile),
            lambda graph: graph.reindex(ks))
        return graph.run()


def _host_indices(indices) -> np.ndarray:
    return np.asarray(indices.cpu() if isinstance(indices, torch.Tensor)
                      else indices).reshape(-1)


def _host_loop(one, ks) -> torch.Tensor:
    """Shot body ``one`` over the host indices ``ks``, one shot after
    another, into one (n_shots, ...) tensor."""
    outs = None
    for i, k in enumerate(ks):
        out = one(int(k))
        if outs is None:
            outs = out.new_empty((len(ks),) + tuple(out.shape))
        outs[i] = out
    if outs is None:
        raise ValueError("run_sequence needs at least one shot")
    return outs


def run_sequence_loop(seq, indices, ba_filters=None, demod_freqs=None,
                      rows_per_tile: int | None = None) -> torch.Tensor:
    """:func:`run_sequence` as a loop on the host: each shot's index read
    there, and its launches made one after another, with its constants
    made for the call.  The plain version that :func:`run_sequence` is
    held to, on the card's graph and on the CPU's kept shot body."""
    return _host_loop(_shot_body(seq, ba_filters, demod_freqs,
                                 rows_per_tile), _host_indices(indices))


class SequenceGraph:
    """:func:`run_sequence`'s shot on a CUDA device as one CUDA graph.

    The shot body -- the shot's index gathered from the device vector of
    indices at a device shot counter (``index_select``), K1's shot entry on
    it, the float64 cast, S1's kernels, the demodulation's products,
    ``outs.index_copy_`` at the counter and ``counter += 1`` -- runs once
    eagerly on a side stream as shot 0 (which builds the kernels and
    creates the BLAS handle before the capture).  With more shots it is
    then captured once on that stream (``torch.cuda.graph``) into a graph
    with its own memory pool, which holds one shot's intermediates; a
    single shot is not captured (``graph`` None) and runs eagerly again
    on each later run.  :meth:`run` replays the graph once a shot on the
    current stream: no host read of an index, no host-side launch of a
    kernel, and the Python kernel counters see the eager shot and the
    capture, not the replays.  :meth:`reindex` gives the next run other
    indices, so :func:`run_sequence` captures once a key and keeps the
    graph on the Sequencer.  Spans: the constants and indices
    ``wf.sequence.constants``, shot 0 ``wf.sequence.eager_shot``, the
    capture ``wf.sequence.capture`` (from before the graph's entry -- its
    synchronize and cache emptying -- to the instantiated graph) and the
    replays ``wf.sequence.replay``.
    The object holds every tensor the graph reads that was made before the
    capture (the table, the indices, the counter, the filter's and the
    demodulation's constants in the shot body's closure): freed, their
    memory would be handed out again while the graph still reads it.
    """

    def __init__(self, seq, indices, ba_filters=None, demod_freqs=None,
                 rows_per_tile: int | None = None):
        self.seq = seq
        self._one = one = _shot_body(seq, ba_filters, demod_freqs,
                                     rows_per_tile)
        dev = seq.device
        with annotate('wf.sequence.constants'):
            self.ks = seq.shot_indices(indices)
            self.n_shots = self.ks.shape[0]
            if not self.n_shots:
                raise ValueError("run_sequence needs at least one shot")
            self.counter = torch.zeros(1, dtype=torch.int64, device=dev)

        def shot():
            return one(self.ks.index_select(0, self.counter).reshape(()))

        def keep(out):
            self.outs.index_copy_(0, self.counter, out[None])
            self.counter.add_(1)

        self._shot, self._keep = shot, keep
        stream = torch.cuda.current_stream(dev)
        with annotate('wf.sequence.eager_shot'):
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                first = shot()
                self.outs = first.new_empty((self.n_shots,) + first.shape)
                keep(first)
            del first
        self.graph = None
        if self.n_shots > 1:
            with annotate('wf.sequence.capture'):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=side):
                    keep(shot())
        stream.wait_stream(side)
        self._stream = stream           # where the last work was queued
        self._next = 1                  # shot 0 ran eagerly

    def _follow(self):
        """Queue what follows on the current stream after the last run's
        work, where that was queued on another stream."""
        stream = torch.cuda.current_stream(self.counter.device)
        if stream != self._stream:
            stream.wait_stream(self._stream)
            self._stream = stream

    def reindex(self, indices):
        """Take ``indices`` (as ``Sequencer.shot_indices`` takes them, one
        a shot) as the next run's, copied on the current stream after the
        last run's work."""
        self._follow()
        ks = self.seq.shot_indices(indices)
        if ks.shape != self.ks.shape:
            raise ValueError(f"expected {self.n_shots} indices, got "
                             f"{ks.shape[0]}")
        self.ks.copy_(ks)

    def run(self) -> torch.Tensor:
        """Play every shot not yet played (all of them again after the
        first run) on the current stream, after the last run's work ->
        a fresh tensor (n_shots, ...) of the shots' results."""
        self._follow()
        with annotate('wf.sequence.replay'):
            if self._next == 0:
                self.counter.zero_()
                if self.graph is None:
                    self._keep(self._shot())
            if self.graph is not None:
                for _ in range(self._next, self.n_shots):
                    self.graph.replay()
            self._next = 0
            return self.outs.clone()

    def release(self):
        """Wait for the last run's work, then free the graph and its
        memory pool (a program the Sequencer no longer keeps)."""
        self._stream.synchronize()
        if self.graph is not None:
            self.graph.reset()
