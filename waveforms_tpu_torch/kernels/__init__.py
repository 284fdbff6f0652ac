"""Build, bind and launch the hand-written CUDA kernels.

The sources in ``waveforms_tpu_torch/csrc/`` compile with nvcc at first
use, each into an object file, all at once in parallel, and link into one
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/synth_<name>.cu     (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared *.o

(no ``--use_fast_math``: it would change expf/sinf/division and flush
denormals).  The library goes to ``build/waveforms_tpu_torch/`` beside the
package, named by a hash of the sources, so an edited source rebuilds.

One wrapper per kernel: :data:`synth_dense` (K1, the dense grid),
:data:`synth_panel` (K2, the panel walk), :data:`synth_sparse` (K7, the
worklist walk), :data:`synth_stack` (K5, pulse instances), its sequenced
twin :data:`synth_stack_seq` (K6, one launch for a shot vector over stacked
tables), the double tier's :data:`synth_dense_hi` (K3) and
:data:`synth_panel_hi` (K4), the signal chain's IIR recurrence
:data:`iir_df2t` (S1, a port kernel with no Pallas counterpart, a blocked
scan of five kernels a call), the trace evaluator
:data:`trace_eval` (T1, a port kernel: the IR's tape, ``ops/trace_tape.py``,
evaluated in one launch, the counterpart of the XLA program that JAX's
``jax_eval.compile_waveform`` jits), and the
measurement probes of ``csrc/probes.cu`` (:data:`probe_health`,
:data:`probe_grid`, :data:`probe_walker`, :data:`probe_sparse_compact`;
run by :mod:`..probes`).  A wrapper given tensors on the CPU runs the
kernel's plain version (:mod:`..ops.reference`, :mod:`..ops.reference_hi`,
:mod:`..ops.reference_iir`, :mod:`..ops.reference_probes`,
:mod:`..ops.reference_trace`); given CUDA
tensors it launches the kernel, checks the launch's ``cudaGetLastError()``
and raises on any failure -- it never falls back.  Each wrapper counts its
kernel launches in ``launches``, and opens the span ``wf.launch.<name>``
(``wf.launch.<name>.shots`` for a shot entry) around each launch
(:func:`..utils.profiling.annotate`); K1's counts those with a window that
starts after sample 0 again in ``windowed_launches``.  K1 and K7 also have
a shot entry, ``synth_dense.shots`` and ``synth_sparse.shots``: one launch
for a shot vector over a sequence table, whose kernel reads each shot's
schedule index on the device (counted in ``launches`` and again in
``shot_launches``).

Output kinds: f32; int16 DAC codes with a per-channel f32 scale; bf16 and
f16, the f32 sum rounded once to nearest even; and, for the three
descriptor walks, complex64 in pair mode (a schedule with ``amp_im``),
written as interleaved (re, im) f32 pairs.  The double-tier kernels store
float64, or the f32 (hi, lo) planes of the f64 sums.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..ops import (reference, reference_hi, reference_iir,
                   reference_probes, reference_trace)
from ..utils.profiling import annotate

__all__ = ['synth_dense', 'synth_panel', 'synth_sparse', 'synth_stack',
           'synth_stack_seq', 'synth_dense_hi', 'synth_panel_hi',
           'probe_health', 'probe_grid', 'probe_walker',
           'probe_sparse_compact', 'iir_df2t', 'iir_df2t_smem_bytes',
           'iir_df2t_chunk', 'trace_eval',
           'launch_dense', 'launch_dense_shots',
           'launch_dense_hi', 'launch_sparse', 'launch_sparse_shots',
           'launch_probe_sparse_compact',
           'launch_stack',
           'launch_stack_seq',
           'dense_tile', 'load_library', 'library_path',
           'reset_launch_counts', 'launch_counts', 'KERNELS']

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
SOURCES = ('synth_dense.cu', 'synth_panel.cu', 'synth_sparse.cu',
           'synth_stack.cu', 'synth_stack_seq.cu', 'synth_dense_hi.cu',
           'synth_panel_hi.cu', 'probes.cu', 'iir_df2t.cu', 'trace_eval.cu')
HEADERS = ('synth_common.cuh', 'synth_span.cuh', 'synth_item.cuh',
           'synth_stack_common.cuh', 'synth_hi_common.cuh')
BUILD_DIR = _PKG.parent / 'build' / 'waveforms_tpu_torch'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xptxas', '-v',
                           '-Xcompiler', '-fPIC')
# a source's own flags: T1 rounds every product and sum as the plain
# version's torch operations do, one at a time (no contracted multiply-add)
SOURCE_FLAGS = {'trace_eval.cu': ('-fmad=false',)}

# largest dense-kernel tile (samples per thread block); K1 and K3 each take
# the smaller of it and their own (synth_dense.cu DENSE_TILE,
# synth_dense_hi.cu HI_TILE), powers of two all
DENSE_TILE = 8192

_lock = threading.Lock()
_lib = None
#: nvcc's output of the build that produced the loaded library
build_log = ''


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f'libwfsynth_{_source_hash()}.so'


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').exists():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build from source at first use")
    return found


def _build(path: Path) -> str:
    """Compile every source at once (one nvcc each), then link."""
    path.parent.mkdir(parents=True, exist_ok=True)
    stem = path.parent / f'{path.stem}.{os.getpid()}'
    objs = [Path(f'{stem}.{Path(src).stem}.o') for src in SOURCES]
    tmp = Path(f'{stem}.so.tmp')
    nvcc = _nvcc()
    log = []
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), '-c', '-o',
             str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        failed = []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            log.append(out)
            if p.returncode != 0:
                failed.append(f"{src} ({p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        r = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)       # atomic: concurrent builders never clash
    finally:
        for f in (*objs, tmp):
            if f.exists():
                f.unlink()
    return '\n'.join(log)


def load_library():
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build_log = _build(path)
        lib = ctypes.CDLL(str(path))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wf_synth_dense.argtypes = ([P] * 14 + [I] * 5 + [L, L, L, L, I]
                                       + [P, I, P, P])
        lib.wf_synth_dense_shard.argtypes = ([P] * 14 + [I] * 5
                                             + [L, L, L, L, L, I]
                                             + [P, I, P, P])
        lib.wf_synth_dense_shots.argtypes = ([P] * 14 + [I] * 5 + [L, L]
                                             + [P, I, I, I, P, I, P, P])
        lib.wf_synth_panel.argtypes = ([P] * 13 + [I] * 5 + [L, L]
                                       + [P] * 5 + [I, I, I, L]
                                       + [P, I, P, P])
        lib.wf_synth_sparse.argtypes = ([P] * 13 + [I] * 5 + [L, L]
                                        + [P] * 6 + [I, I, I, L]
                                        + [P, I, P, P])
        lib.wf_synth_sparse_shots.argtypes = ([P] * 13 + [I] * 5 + [L, L]
                                              + [P] * 6 + [I, P, I, I, I, I,
                                                           L, P, I, P, P])
        lib.wf_synth_stack.argtypes = ([P] * 12 + [I] * 4 + [L]
                                       + [P, I, P, P])
        lib.wf_synth_stack_seq.argtypes = ([P] * 13 + [I] * 5 + [L, I]
                                           + [P, I, P, P])
        lib.wf_synth_stack_seq_window.argtypes = ([P] * 13 + [I] * 5
                                                  + [L, I, I, L, I]
                                                  + [P, I, P, P])
        lib.wf_synth_dense_hi.argtypes = ([P] * 13 + [I] * 5 + [L, L, I]
                                          + [P, P, I, P])
        lib.wf_synth_panel_hi.argtypes = ([P] * 12 + [I] * 5 + [L, L]
                                          + [P] * 5 + [I, I, I, L]
                                          + [P, P, I, P])
        lib.wf_probe_health.argtypes = [P, P, L, P]
        lib.wf_probe_grid.argtypes = [P, I, P, P, I, I, I, I, I, P, P]
        lib.wf_probe_walker.argtypes = [I, P, P, P, I, I, I, P, P]
        lib.wf_probe_sparse_compact.argtypes = ([P] * 12 + [I] * 5 + [L, L]
                                                + [P] * 5 + [I, I, P, P])
        lib.wf_iir_df2t.argtypes = [P] * 8 + [I, L, I, I, P]
        lib.wf_iir_df2t_smem_bytes.argtypes = [I]
        lib.wf_iir_df2t_smem_bytes.restype = I
        lib.wf_iir_df2t_chunk.argtypes = []
        lib.wf_iir_df2t_chunk.restype = I
        lib.wf_iir_df2t_work_doubles.argtypes = [I, L, I]
        lib.wf_iir_df2t_work_doubles.restype = L
        lib.wf_trace_eval.argtypes = [P, P, P, L, P, P, P, I, I, I, I, P]
        for fn in (lib.wf_synth_dense, lib.wf_synth_dense_shard,
                   lib.wf_synth_dense_shots, lib.wf_synth_panel,
                   lib.wf_synth_sparse, lib.wf_synth_sparse_shots,
                   lib.wf_synth_stack,
                   lib.wf_synth_stack_seq, lib.wf_synth_stack_seq_window,
                   lib.wf_synth_dense_hi,
                   lib.wf_synth_panel_hi, lib.wf_probe_health,
                   lib.wf_probe_grid, lib.wf_probe_walker,
                   lib.wf_probe_sparse_compact, lib.wf_iir_df2t,
                   lib.wf_trace_eval):
            fn.restype = I
        lib.wf_error_string.argtypes = [I]
        lib.wf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check_cuda(tensors, device):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _descriptors(d, dense):
    names = (('seg_lo', 'seg_hi', 'seg_hmax') if dense
             else ('seg_lo', 'seg_hi')) + (
        'nterm', 'nfac', 'amp', 'op', 'power', 'shift_hi', 'q32', 'args',
        'ext', 'clip')
    return {n: getattr(d, n) for n in names}


def _ptr(t):
    return None if t is None else t.data_ptr()


# csrc/synth_common.cuh's OutKind, by output dtype
_OUT_KINDS = {torch.float32: 0, torch.int16: 1, torch.complex64: 2,
              torch.bfloat16: 3, torch.float16: 4}


def _out_kind(out, scale, shape, pair=False):
    """0 f32, 1 int16 codes, 2 complex64 (pair mode), 3 bf16, 4 f16;
    raises on anything the kernels do not take."""
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {shape}")
    if pair != (out.dtype == torch.complex64):
        raise ValueError("a pair-mode schedule (amp_im) needs a complex64 "
                         "output, and a complex64 output needs one")
    if out.dtype not in _OUT_KINDS:
        raise ValueError(f"unsupported output dtype {out.dtype}")
    if out.dtype == torch.int16 and (scale is None
                                     or scale.dtype != torch.float32):
        raise ValueError("int16 output needs a per-channel f32 scale")
    return _OUT_KINDS[out.dtype]


def _checked(d, dense, out, scale, shape, **extra):
    """Validate a descriptor-walk launch -> (out kind, descriptor
    pointers incl. amp_im)."""
    pair = d.amp_im is not None
    kind = _out_kind(out, scale, shape, pair)
    desc = _descriptors(d, dense)
    tensors = dict(desc, out=out, **extra)
    if kind == 1:
        tensors['scale'] = scale
    if pair:
        tensors['amp_im'] = d.amp_im
    _check_cuda(tensors, out.device)
    if shape[0] > 65535:
        raise ValueError("at most 65535 channels per launch")
    return kind, [t.data_ptr() for t in desc.values()] + [_ptr(d.amp_im)]


def _raise_on(code, name):
    if code != 0:
        msg = load_library().wf_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


class _Kernel:
    """A kernel wrapper with its launch count and its launch's span
    ``wf.launch.<name>``; ``out_at`` is the position of the output among
    the arguments."""

    def __init__(self, name, source, replaces, plain, launch, out_at=-2):
        self.name = name
        self.source = source        # path in the repo
        self.replaces = replaces    # the TPU kernel, file:line
        self.plain = plain          # the plain PyTorch version
        self._launch = launch
        self._out_at = out_at
        self._span = f'wf.launch.{name}'
        self.launches = 0

    def __call__(self, *args):
        out = args[self._out_at]
        if out.device.type == 'cpu':
            return self.plain(*args)
        if out.device.type != 'cuda':
            raise ValueError(f"{self.name}: unsupported device {out.device}")
        with annotate(self._span):
            self._launch(*args)
        self.launches += 1
        return out


class _ShotKernel(_Kernel):
    """A wrapper with a shot entry, :meth:`shots`: one launch of the
    kernel's shot variant ``launch_shots`` for a shot vector over a
    sequence table (plain version ``plain_shots``), counted in
    ``launches`` and again in ``shot_launches``, its span
    ``wf.launch.<name>.shots``."""

    def __init__(self, *args, plain_shots, launch_shots, **kw):
        super().__init__(*args, **kw)
        self.plain_shots = plain_shots
        self._launch_shots = launch_shots
        self._shots_span = f'{self._span}.shots'
        self.shot_launches = 0

    def shots(self, *args):
        out = args[-2]
        if out.device.type == 'cpu':
            return self.plain_shots(*args)
        if out.device.type != 'cuda':
            raise ValueError(f"{self.name}: unsupported device {out.device}")
        if out.shape[0]:
            with annotate(self._shots_span):
                self._launch_shots(*args)
            self.launches += 1
            self.shot_launches += 1
        return out


class _DenseKernel(_ShotKernel):
    """K1's wrapper: of its launches, those whose window starts after
    sample 0 (``row0 != 0``) are counted again in ``windowed_launches``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windowed_launches = 0

    def __call__(self, dev, out, scale=None, row0=0, n_out=None, bucket0=0):
        result = super().__call__(dev, out, scale, row0, n_out, bucket0)
        if out.device.type == 'cuda' and row0:
            self.windowed_launches += 1
        return result


class _IirKernel(_Kernel):
    """S1's wrapper: ``y`` None is the state-only call, which writes zf
    alone (the chunk pass, the carry and a walk of each row's last chunk,
    no output pass) and returns it; its launches are counted again in
    ``state_launches``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.state_launches = 0

    def __call__(self, x, coef, zi, y, zf):
        if y is not None:
            return super().__call__(x, coef, zi, y, zf)
        if zf.device.type == 'cpu':
            self.plain(x, coef, zi, None, zf)
            return zf
        if zf.device.type != 'cuda':
            raise ValueError(f"{self.name}: unsupported device {zf.device}")
        with annotate(self._span):
            self._launch(x, coef, zi, None, zf)
        self.launches += 1
        self.state_launches += 1
        return zf


def dense_tile(d, largest=DENSE_TILE, row0=0):
    """Largest power-of-two tile <= ``largest`` that divides the bucket, so
    that no tile straddles two buckets, and the window's offset ``row0`` (a
    multiple of 128), from which the tiles are placed."""
    tile = largest
    if d.shape[1] > 1:
        while tile > 128 and d.bucket_samples % tile:
            tile //= 2
        if d.bucket_samples % tile:
            raise ValueError(f"bucket_samples {d.bucket_samples} must be a "
                             "multiple of 128")
    while tile > 128 and row0 % tile:
        tile //= 2
    return tile


def _stream(out):
    return torch.cuda.current_stream(out.device).cuda_stream


def launch_dense(d, out, scale=None, row0=0, n_out=None, bucket0=0,
                 lib=None, largest=DENSE_TILE):
    """Launch K1 on CUDA tensors, uncounted (:data:`synth_dense` counts),
    over the window [row0, row0 + n_out) of the schedule
    (:func:`..ops.reference.dense_window`: ``row0`` a multiple of 128,
    ``n_out`` by default the rest of the schedule; a bad window raises).
    ``bucket0`` is the schedule's bucket that the descriptors' bucket 0
    holds (a time shard's slice of the bucket axis, ``parallel.mesh``).
    ``lib`` (default: this build) may be another build of
    ``csrc/synth_dense.cu`` with the same C interface, given the largest
    tile its own wrapper passed: an A/B of two builds (at ``bucket0`` 0
    through ``wf_synth_dense``, the interface such builds share)."""
    C, NB, S, T, F = d.shape
    n_out = reference.dense_window(d, row0, n_out)
    bucket0 = reference.dense_bucket0(bucket0)
    kind, desc = _checked(d, True, out, scale, (C, n_out))
    lib = lib or load_library()
    head = (*desc, C, NB, S, T, F, d.n_samples, d.bucket_samples, int(row0),
            n_out)
    tail = (dense_tile(d, largest, int(row0)), out.data_ptr(), kind,
            _ptr(scale), _stream(out))
    with torch.cuda.device(out.device):
        code = (lib.wf_synth_dense_shard(*head, bucket0, *tail) if bucket0
                else lib.wf_synth_dense(*head, *tail))
    _raise_on(code, 'synth_dense')


def _shot_vector(t, ks):
    """(K, n_shots) of a shot launch over the sequence table ``t``;
    raises unless ``ks`` is a 1-D int32 tensor."""
    if ks.dim() != 1 or ks.dtype != torch.int32:
        raise ValueError("ks must be a 1-D int32 tensor")
    K, C = t.seg_lo.shape[0], t.shape[0]
    if C > 65535:
        raise ValueError("at most 65535 channels per launch")
    if K * C > 2 ** 31 - 1:
        raise ValueError("the table holds more than 2**31 - 1 channels")
    return K, ks.shape[0]


def launch_dense_shots(t, ks, out, scale=None):
    """Launch K1's shot entry on CUDA tensors, uncounted
    (``synth_dense.shots`` counts): ``out`` (n_shots, C, N) holds, at shot
    s, schedule ``clamp(ks[s], 0, K - 1)`` of the sequence table ``t``
    (the (K, ...) descriptor tensors of a :class:`..ops.Sequencer`);
    ``ks`` (n_shots,) int32 stays on the device, where each block reads
    and clamps its shot's index."""
    C, NB, S, T, F = t.shape
    K, n_shots = _shot_vector(t, ks)
    kind = _out_kind(out, scale, (n_shots, C, t.n_samples),
                     t.amp_im is not None)
    desc = _descriptors(t, True)
    tensors = dict(desc, out=out, ks=ks)
    if kind == 1:
        tensors['scale'] = scale
    if t.amp_im is not None:
        tensors['amp_im'] = t.amp_im
    _check_cuda(tensors, out.device)
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_dense_shots(
            *(v.data_ptr() for v in desc.values()), _ptr(t.amp_im), C, NB, S,
            T, F, t.n_samples, t.bucket_samples, ks.data_ptr(), K, n_shots,
            dense_tile(t), out.data_ptr(), kind, _ptr(scale), _stream(out))
    _raise_on(code, 'synth_dense shots')


def _launch_panel(d, work, out, scale):
    C, NB, S, T, F = d.shape
    plan = {n: getattr(work, n) for n in
            ('start', 'work_t', 'work_o', 'work_s0', 'work_s1')}
    kind, desc = _checked(d, False, out, scale, (C, out.shape[1]), **plan)
    if work.n_panels > 65535:
        raise ValueError("at most 65535 panels per launch")
    if kind in (1, 3, 4) and NB > 1:
        raise ValueError("int16, bf16 and f16 panel output need a single "
                         "bucket (several accumulate in the output)")
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_panel(
            *desc, C, NB, S, T, F, d.n_samples, d.bucket_samples,
            *(t.data_ptr() for t in plan.values()), work.Rs, work.P,
            work.n_panels, out.shape[1], out.data_ptr(), kind, _ptr(scale),
            _stream(out))
    _raise_on(code, 'synth_panel')


def launch_sparse(d, work, out, scale=None, lib=None):
    """Launch K7 on CUDA tensors, uncounted (:data:`synth_sparse` counts):
    items on the grid's x axis, each item's Rs x 128 subtile cut into
    passes of 1024 samples on its y axis (``csrc/synth_item.cuh``).
    ``lib`` (default: this build) may be another build of
    ``csrc/synth_sparse.cu`` with the same C interface: an A/B of two
    builds."""
    C, NB, S, T, F = d.shape
    plan = {n: getattr(work, n) for n in
            ('work_c', 'work_b', 'work_t', 'work_o', 'work_s0', 'work_s1')}
    kind, desc = _checked(d, False, out, scale, (C, out.shape[1]), **plan)
    if NB > 1 and d.bucket_samples % (work.Rs * 128):
        raise ValueError("buckets must be whole subtiles, so that no output "
                         "subtile has two worklist items")
    lib = lib or load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_sparse(
            *desc, C, NB, S, T, F, d.n_samples, d.bucket_samples,
            *(t.data_ptr() for t in plan.values()), work.work_c.shape[0],
            work.Rs, work.n_tiles, out.shape[1], out.data_ptr(), kind,
            _ptr(scale), _stream(out))
    _raise_on(code, 'synth_sparse')


def launch_sparse_shots(t, work, ks, out, scale=None):
    """Launch K7's shot entry on CUDA tensors, uncounted
    (``synth_sparse.shots`` counts): ``out`` (n_shots, C, window), zeroed,
    receives at shot s the live subtiles of schedule ``k = clamp(ks[s], 0,
    K - 1)`` of the sequence table ``t`` (as :func:`launch_dense_shots`'s)
    from row k of the stacked worklists ``work`` (a SparseWork whose
    ``work_*`` are (K, Kw) int32; padding items, ``work_o == n_tiles``,
    write nothing).  ``ks`` stays on the device."""
    C, NB, S, T, F = t.shape
    K, n_shots = _shot_vector(t, ks)
    plan = {n: getattr(work, n) for n in
            ('work_c', 'work_b', 'work_t', 'work_o', 'work_s0', 'work_s1')}
    Kw = work.work_c.shape[-1]
    if any(tuple(v.shape) != (K, Kw) or v.dtype != torch.int32
           for v in plan.values()):
        raise ValueError(f"the worklists are ({K}, Kw) int32 tensors")
    kind = _out_kind(out, scale, (n_shots, C, out.shape[-1]),
                     t.amp_im is not None)
    desc = _descriptors(t, False)
    tensors = dict(desc, out=out, ks=ks, **plan)
    if kind == 1:
        tensors['scale'] = scale
    if t.amp_im is not None:
        tensors['amp_im'] = t.amp_im
    _check_cuda(tensors, out.device)
    if NB > 1 and t.bucket_samples % (work.Rs * 128):
        raise ValueError("buckets must be whole subtiles, so that no output "
                         "subtile has two worklist items")
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_sparse_shots(
            *(v.data_ptr() for v in desc.values()), _ptr(t.amp_im), C, NB, S,
            T, F, t.n_samples, t.bucket_samples,
            *(v.data_ptr() for v in plan.values()), Kw, ks.data_ptr(), K,
            n_shots, work.Rs, work.n_tiles, out.shape[2], out.data_ptr(),
            kind, _ptr(scale), _stream(out))
    _raise_on(code, 'synth_sparse shots')


_STACK_TABLES = ('inst', 'amp', 'term_nfac', 'op', 'power', 'shift_hi', 'q32',
                 'args', 'ext', 'blk_inst', 'blk_row', 'chunk_start')


def _stack_checked(t, out, scale, shape, **extra):
    """Validate a stack-table launch -> (out kind, tables by name)."""
    kind = _out_kind(out, scale, shape)
    if kind == 2:
        raise ValueError("the stack kernels have no pair mode")
    tables = {n: getattr(t, n) for n in _STACK_TABLES}
    _check_cuda(dict(tables, out=out, **extra,
                     **({'scale': scale} if kind == 1 else {})), out.device)
    return kind, tables


def launch_stack(t, out, scale=None, lib=None):
    """Launch K5 on CUDA tensors, uncounted (:data:`synth_stack` counts).
    ``lib`` (default: this build) may be another build of
    ``csrc/synth_stack.cu`` with the same C interface: an A/B of two
    builds."""
    if t.chunk_start.dim() != 1:
        raise ValueError("stacked tables (a 2-D chunk_start) are K6's")
    kind, tables = _stack_checked(t, out, scale, (t.n_channels, t.n_samples))
    lib = lib or load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_stack(
            *(v.data_ptr() for v in tables.values()), t.NT, t.TF,
            t.n_channels, t.n_chunks, t.n_samples, out.data_ptr(), kind,
            _ptr(scale), _stream(out))
    _raise_on(code, 'synth_stack')


def launch_stack_seq(t, ks, out, scale=None, chunk0=0, n_chunks=None,
                     lib=None):
    """Launch K6 on CUDA tensors, uncounted (:data:`synth_stack_seq`
    counts), over chunks [chunk0, chunk0 + n_chunks) of every channel
    (:func:`..ops.reference.stack_window`; by default the whole table).
    ``lib`` as :func:`launch_stack`'s, for another build of
    ``csrc/synth_stack_seq.cu`` (whole tables through ``wf_synth_stack_seq``,
    the interface such builds share)."""
    K = t.chunk_start.shape[0]
    if tuple(t.chunk_start.shape) != (K, t.n_channels * t.n_chunks + 1):
        raise ValueError("chunk_start must be (K, C * n_chunks + 1)")
    if ks.dim() != 1 or ks.dtype != torch.int32:
        raise ValueError("ks must be a 1-D int32 tensor")
    n_shots = ks.shape[0]
    chunk0, n_win, n_local = reference.stack_window(t, chunk0, n_chunks)
    kind, tables = _stack_checked(t, out, scale,
                                  (n_shots, t.n_channels, n_local), ks=ks)
    lib = lib or load_library()
    head = (*(v.data_ptr() for v in tables.values()), ks.data_ptr(), t.NT,
            t.TF, K, t.n_channels, t.n_chunks, t.n_samples)
    tail = (n_shots, out.data_ptr(), kind, _ptr(scale), _stream(out))
    with torch.cuda.device(out.device):
        code = (lib.wf_synth_stack_seq(*head, *tail)
                if n_local == t.n_samples else
                lib.wf_synth_stack_seq_window(*head, chunk0, n_win, n_local,
                                              *tail))
    _raise_on(code, 'synth_stack_seq')


def _hi_checked(d, dense, out, lo, shape, **extra):
    """Validate a double-tier launch -> (out kind: 0 f64, 1 f32 hi/lo
    planes; descriptor pointers)."""
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {shape}")
    if lo is None:
        if out.dtype != torch.float64:
            raise ValueError("a double-tier output is float64, or two f32 "
                             "planes (out, lo)")
        kind = 0
    else:
        if (out.dtype, lo.dtype) != (torch.float32, torch.float32) or (
                lo.shape != out.shape):
            raise ValueError("the (hi, lo) planes are two f32 tensors of "
                             "one shape")
        kind = 1
    names = (('seg_lo', 'seg_hi', 'seg_hmax') if dense
             else ('seg_lo', 'seg_hi')) + (
        'nterm', 'nfac', 'amp64', 'op', 'power', 'shift_hi', 'q32', 'args64',
        'ext64', 'clip')
    desc = {n: getattr(d, n) for n in names}
    _check_cuda(dict(desc, out=out, **({'lo': lo} if kind else {}), **extra),
                out.device)
    if shape[0] > 65535:
        raise ValueError("at most 65535 channels per launch")
    return kind, [t.data_ptr() for t in desc.values()]


def launch_dense_hi(d, out, lo=None, lib=None, largest=DENSE_TILE):
    """Launch K3 on CUDA tensors, uncounted; ``lib`` and ``largest`` as
    :func:`launch_dense`'s, for another build of ``csrc/synth_dense_hi.cu``."""
    C, NB, S, T, F = d.shape
    kind, desc = _hi_checked(d, True, out, lo, (C, d.n_samples))
    lib = lib or load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_dense_hi(
            *desc, C, NB, S, T, F, d.n_samples, d.bucket_samples,
            dense_tile(d, largest), out.data_ptr(), _ptr(lo), kind,
            _stream(out))
    _raise_on(code, 'synth_dense_hi')


def _launch_panel_hi(d, work, out, lo):
    C, NB, S, T, F = d.shape
    if NB != 1:
        raise ValueError("the hi panel kernel takes single-bucket schedules")
    plan = {n: getattr(work, n) for n in
            ('start', 'work_t', 'work_o', 'work_s0', 'work_s1')}
    kind, desc = _hi_checked(d, False, out, lo, (C, out.shape[1]), **plan)
    if work.n_panels > 65535:
        raise ValueError("at most 65535 panels per launch")
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_synth_panel_hi(
            *desc, C, NB, S, T, F, d.n_samples, d.bucket_samples,
            *(t.data_ptr() for t in plan.values()), work.Rs, work.P,
            work.n_panels, out.shape[1], out.data_ptr(), _ptr(lo), kind,
            _stream(out))
    _raise_on(code, 'synth_panel_hi')


def _f32_blocks(out):
    """(n_blocks, Rs, 128) f32 probe output -> (n_blocks, Rs * 128)."""
    if out.dtype != torch.float32 or out.dim() != 3 or out.shape[2] != 128:
        raise ValueError("a probe output is (n_blocks, Rs, 128) f32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    return out.shape[0], out.shape[1] * 128


def _probe_table(name, t, dtype, like=None):
    if t.dtype != dtype or t.dim() != 3 or t.shape[1] != 1 or (
            like is not None and t.shape != like.shape):
        raise ValueError(f"{name} must be a (C, 1, L) {dtype} table"
                         + ("" if like is None else " of the others' shape"))


def _index_vector(name, t, K):
    if t.dtype != torch.int32 or tuple(t.shape) != (K,):
        raise ValueError(f"{name} must be a ({K},) int32 vector")


def _launch_probe_health(x, out):
    if x.dtype != torch.float32 or out.dtype != torch.float32 or (
            x.shape != out.shape):
        raise ValueError("probe_health takes f32 x and out of one shape")
    _check_cuda({'x': x, 'out': out}, out.device)
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_probe_health(x.data_ptr(), out.data_ptr(), out.numel(),
                                   _stream(out))
    _raise_on(code, 'probe_health')


def _launch_probe_grid(tables, wc, wo, n_ops, dyn_in, dyn_out, out):
    n_blocks, tile = _f32_blocks(out)
    K = wc.shape[0]
    if n_ops not in (2, 13) or len(tables) < n_ops:
        raise ValueError("probe_grid touches 2 or 13 tables")
    for r, t in enumerate(tables[:n_ops]):
        _probe_table(f"table {r}", t, torch.float32, tables[0])
    _index_vector('wc', wc, K)
    _index_vector('wo', wo, K)
    if not dyn_out and n_blocks < K:
        raise ValueError(f"a static output map needs {K} blocks")
    _check_cuda(dict({f't{r}': t for r, t in enumerate(tables[:n_ops])},
                     wc=wc, wo=wo, out=out), out.device)
    ptrs = (ctypes.c_void_p * n_ops)(*(t.data_ptr() for t in tables[:n_ops]))
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_probe_grid(
            ctypes.cast(ptrs, ctypes.c_void_p), n_ops, wc.data_ptr(),
            wo.data_ptr(), int(bool(dyn_in)), int(bool(dyn_out)), K,
            tables[0].shape[2], tile, out.data_ptr(), _stream(out))
    _raise_on(code, 'probe_grid')


_WALKER_IDS = {name: i for i, (name, _) in
               enumerate(reference_probes.WALKER_BODIES)}


def _launch_probe_walker(body, wc, ftab, itab, out):
    K, tile = _f32_blocks(out)
    if body not in _WALKER_IDS:
        raise ValueError(f"unknown walker body {body!r}")
    _probe_table('ftab', ftab, torch.float32)
    _probe_table('itab', itab, torch.int32)
    if itab.shape != ftab.shape or ftab.shape[2] < 64:
        raise ValueError("ftab and itab are (C, 1, L) of one shape, L >= 64")
    _index_vector('wc', wc, K)
    _check_cuda({'wc': wc, 'ftab': ftab, 'itab': itab, 'out': out},
                out.device)
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_probe_walker(
            _WALKER_IDS[body], wc.data_ptr(), ftab.data_ptr(),
            itab.data_ptr(), K, ftab.shape[2], tile, out.data_ptr(),
            _stream(out))
    _raise_on(code, 'probe_walker')


def launch_probe_sparse_compact(d, work, out, lib=None):
    """Launch P1 on CUDA tensors, uncounted (:data:`probe_sparse_compact`
    counts): K7's item walker with item k stored at ``out[k]``.  ``lib``
    as :func:`launch_sparse`'s, for another build of ``csrc/probes.cu``."""
    C, NB, S, T, F = d.shape
    K = work.work_c.shape[0]
    if d.amp_im is not None:
        raise ValueError("the compact probe has no pair mode")
    if out.dtype != torch.float32 or tuple(out.shape) != (K, work.Rs, 128):
        raise ValueError(f"out must be ({K}, {work.Rs}, 128) f32")
    plan = {n: getattr(work, n) for n in
            ('work_c', 'work_b', 'work_t', 'work_s0', 'work_s1')}
    desc = _descriptors(d, False)
    _check_cuda(dict(desc, out=out, **plan), out.device)
    lib = lib or load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_probe_sparse_compact(
            *(t.data_ptr() for t in desc.values()), C, NB, S, T, F,
            d.n_samples, d.bucket_samples,
            *(t.data_ptr() for t in plan.values()), K, work.Rs,
            out.data_ptr(), _stream(out))
    _raise_on(code, 'probe_sparse_compact')


# csrc/iir_df2t.cu's dtype codes
_IIR_DTYPES = {torch.float64: 0, torch.float32: 1}


def _launch_iir_df2t(x, coef, zi, y, zf):
    """Launch S1 on CUDA tensors: rows x (R, n) -> y, state zi (R, d) ->
    zf, coefficients ``coef`` = b then a, d + 1 each; ``y`` None writes zf
    alone (the state-only call).  One call runs the blocked scan's kernels
    (five; one where a row is one chunk) on scratch allocated here: the
    chunks' end states (R, K, d, 2) float64, start states (R, K, d), K =
    max(1, ceil(n / chunk)), and the carry's matrices and group states
    (float64, as many as the build asks)."""
    if x.dim() != 2 or (y is not None and y.shape != x.shape):
        raise ValueError("x and y are (rows, n) tensors of one shape")
    d = zi.shape[-1] if zi.dim() == 2 else -1
    if not 1 <= d <= reference_iir.MAX_STATE:
        raise ValueError(f"the recurrence kernel takes a state of 1 to "
                         f"{reference_iir.MAX_STATE} entries, got {d}")
    if (tuple(zi.shape) != (x.shape[0], d) or zf.shape != zi.shape
            or tuple(coef.shape) != (2 * (d + 1),)):
        raise ValueError("zi and zf are (rows, d), coef (2 * (d + 1),)")
    given = {'x': x, 'coef': coef, 'zi': zi, 'zf': zf}
    if y is not None:
        given['y'] = y
    if x.dtype not in _IIR_DTYPES or any(
            t.dtype != x.dtype for t in given.values()):
        raise ValueError("the recurrence runs in float64 or float32, every "
                         "tensor in one of them")
    _check_cuda(given, zf.device)
    lib = load_library()
    rows, n = x.shape
    K = max(1, -(-n // lib.wf_iir_df2t_chunk()))
    ends = torch.empty((rows, K, d, 2), dtype=torch.float64, device=zf.device)
    starts = torch.empty((rows, K, d), dtype=x.dtype, device=zf.device)
    work = torch.empty(lib.wf_iir_df2t_work_doubles(rows, n, d),
                       dtype=torch.float64, device=zf.device)
    with torch.cuda.device(zf.device):
        code = lib.wf_iir_df2t(x.data_ptr(), coef.data_ptr(), zi.data_ptr(),
                               _ptr(y), zf.data_ptr(), ends.data_ptr(),
                               starts.data_ptr(), work.data_ptr(), rows, n, d,
                               _IIR_DTYPES[x.dtype], _stream(zf))
    _raise_on(code, 'iir_df2t')


# csrc/trace_eval.cu's grid types
_TRACE_DTYPES = {torch.float64: 0, torch.float32: 1}


def _launch_trace_eval(prog, pool, grid, ext_re, ext_im, out, mode, real):
    """Launch T1 on CUDA tensors: the tape (``prog`` int32, ``pool``
    float64) over ``grid`` (N,) float64 or float32 into ``out`` (C, N) --
    the grid's type for ``mode`` 0 (real part) and 1 (imaginary part), its
    complex type for 2 -- with the external slots' planes ``ext_re``
    (n_ext, N) and ``ext_im`` (None where no slot is complex); ``real``
    (the tape's ``Tape.real``) takes the real build."""
    if grid.dim() != 1 or grid.dtype not in _TRACE_DTYPES:
        raise ValueError("the grid is a 1-D float64 or float32 tensor")
    if prog.dtype != torch.int32 or pool.dtype != torch.float64:
        raise ValueError("the tape is an int32 prog and a float64 pool")
    n = grid.shape[0]
    want = (grid.dtype if mode in (0, 1) else
            torch.complex128 if grid.dtype == torch.float64
            else torch.complex64)
    if mode not in (0, 1, 2) or out.dtype != want or out.dim() != 2 or (
            out.shape[1] != n):
        raise ValueError(f"out must be (C, {n}) {want} for mode {mode}")
    n_ch = out.shape[0]
    given = {'prog': prog, 'pool': pool, 'grid': grid, 'out': out}
    if ext_re is None and ext_im is not None:
        raise ValueError("an imaginary plane needs its real plane")
    for name, t in (('ext_re', ext_re), ('ext_im', ext_im)):
        if t is not None:
            if t.dtype != grid.dtype or t.dim() != 2 or t.shape[1] != n or (
                    t.shape != ext_re.shape):
                raise ValueError(f"{name} must be (n_ext, {n}) {grid.dtype}")
            given[name] = t
    _check_cuda(given, out.device)
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.wf_trace_eval(prog.data_ptr(), pool.data_ptr(),
                                 grid.data_ptr(), n, _ptr(ext_re),
                                 _ptr(ext_im), out.data_ptr(), n_ch,
                                 _TRACE_DTYPES[grid.dtype], mode,
                                 int(bool(real)), _stream(out))
    _raise_on(code, 'trace_eval')


def iir_df2t_smem_bytes(dtype) -> int:
    """The dynamic shared memory S1's staged kernels (the chunk pass and the
    output pass) take per thread block for a signal of ``dtype``
    (torch.float64 or torch.float32), from this build."""
    return load_library().wf_iir_df2t_smem_bytes(_IIR_DTYPES[dtype])


def iir_df2t_chunk() -> int:
    """The samples a chunk of S1's blocked scan, from this build
    (``reference_iir.CHUNK`` mirrors it)."""
    return load_library().wf_iir_df2t_chunk()


#: K1:``synth_dense(dev, out, scale, row0=0, n_out=None, bucket0=0)`` fills
#: out (C, n_out) with samples [row0, row0 + n_out) (default: all
#: n_samples) of a schedule whose bucket axis starts at bucket ``bucket0``;
#: ``synth_dense.shots(table, ks, out, scale)`` fills out (n_shots, C, N)
#: with schedule clamp(ks[s]) of a sequence table at shot s, in one launch
synth_dense = _DenseKernel(
    'synth_dense', 'waveforms_tpu_torch/csrc/synth_dense.cu',
    'waveforms_tpu/ops/pallas_synth.py:583', reference.dense_walk,
    launch_dense, out_at=1, plain_shots=reference.dense_walk_shots,
    launch_shots=launch_dense_shots)

#: K2: ``synth_panel(dev, work, out, scale)`` fills out (C, window_samples)
synth_panel = _Kernel(
    'synth_panel', 'waveforms_tpu_torch/csrc/synth_panel.cu',
    'waveforms_tpu/ops/sparse_synth.py:476', reference.panel_walk,
    _launch_panel)

#: K7: ``synth_sparse(dev, work, out, scale)`` stores the live subtiles of
#: a SparseWork into a zeroed out (C, window_samples);
#: ``synth_sparse.shots(table, work, ks, out, scale)`` those of schedule
#: clamp(ks[s]) of a sequence table into out[s] (n_shots, C, window), in one
#: launch over the table's (K, Kw) worklists
synth_sparse = _ShotKernel(
    'synth_sparse', 'waveforms_tpu_torch/csrc/synth_sparse.cu',
    'waveforms_tpu/ops/sparse_synth.py:199', reference.sparse_walk,
    launch_sparse, plain_shots=reference.sparse_walk_shots,
    launch_shots=launch_sparse_shots)

#: K5: ``synth_stack(tables, out, scale)`` fills out (C, n_samples) from
#: StackTables
synth_stack = _Kernel(
    'synth_stack', 'waveforms_tpu_torch/csrc/synth_stack.cu',
    'waveforms_tpu/ops/stack_synth.py:1145', reference.stack_eval,
    launch_stack)

#: K6: ``synth_stack_seq(tables, ks, out, scale, chunk0=0, n_chunks=None)``
#: fills out (n_shots, C, n_local) from stacked StackTables, shot s from
#: schedule clamp(ks[s]), with chunks [chunk0, chunk0 + n_chunks) of each
#: channel (default: all, n_local = n_samples)
synth_stack_seq = _Kernel(
    'synth_stack_seq', 'waveforms_tpu_torch/csrc/synth_stack_seq.cu',
    'waveforms_tpu/ops/stack_seq.py:488', reference.stack_seq_eval,
    launch_stack_seq, out_at=2)

#: K3: ``synth_dense_hi(hidev, out, lo)`` fills out (C, n_samples), f64
#: (``lo`` None) or the f32 hi plane with ``lo`` the lo plane
synth_dense_hi = _Kernel(
    'synth_dense_hi', 'waveforms_tpu_torch/csrc/synth_dense_hi.cu',
    'waveforms_tpu/ops/hi_synth.py:463', reference_hi.dense_walk_hi,
    launch_dense_hi)

#: K4: ``synth_panel_hi(hidev, work, out, lo)`` fills out (C,
#: window_samples) from a single-bucket schedule's PanelWork
synth_panel_hi = _Kernel(
    'synth_panel_hi', 'waveforms_tpu_torch/csrc/synth_panel_hi.cu',
    'waveforms_tpu/ops/hi_synth.py:555', reference_hi.panel_walk_hi,
    _launch_panel_hi)

_PROBES = 'waveforms_tpu_torch/csrc/probes.cu'

#: P4: ``probe_health(x, out)``: out = 2 * x
probe_health = _Kernel(
    'probe_health', _PROBES, 'tools/tpu_capture.py:2690',
    reference_probes.health, _launch_probe_health, out_at=-1)

#: P2: ``probe_grid(tables, wc, wo, n_ops, dyn_in, dyn_out, out)``: the grid
#: overhead probe's trivial body over out (n_blocks, Rs, 128); steps that
#: fill one block must store one value (the card does not order them)
probe_grid = _Kernel(
    'probe_grid', _PROBES, 'tools/tpu_capture.py:1494',
    reference_probes.grid, _launch_probe_grid, out_at=-1)

#: P3: ``probe_walker(body, wc, ftab, itab, out)``: one walker-cost body
#: over out (K, Rs, 128)
probe_walker = _Kernel(
    'probe_walker', _PROBES, 'tools/tpu_capture.py:1559',
    reference_probes.walker, _launch_probe_walker, out_at=-1)

#: P1: ``probe_sparse_compact(dev, work, out)``: the worklist kernel's
#: subtiles stored at out[k] (K, Rs, 128), through K7's item walker
probe_sparse_compact = _Kernel(
    'probe_sparse_compact', _PROBES, 'tools/tpu_capture.py:1424',
    reference_probes.sparse_compact, launch_probe_sparse_compact,
    out_at=-1)

#: S1: ``iir_df2t(x, coef, zi, y, zf)``: direct form II transposed over the
#: rows of x (R, n) into y, state zi (R, d) -> zf, as a blocked scan over
#: chunks; a port kernel with no Pallas counterpart (it replaces the
#: lax.scan of the JAX package's ``_sequential_filter``).  ``y`` None: zf
#: alone.  ``launches`` counts calls, each five CUDA kernels (one where a
#: row is one chunk); ``state_launches`` the state-only ones among them
iir_df2t = _IirKernel(
    'iir_df2t', 'waveforms_tpu_torch/csrc/iir_df2t.cu',
    'waveforms_tpu/ops/iir.py:171', reference_iir.df2t,
    _launch_iir_df2t, out_at=3)

#: T1: ``trace_eval(prog, pool, grid, ext_re, ext_im, out, mode, real)``:
#: every channel of a trace tape (``ops.trace_tape``) over a float64 or
#: float32 grid in one launch, a real tape (``real``) in the real build; a
#: port kernel with no Pallas counterpart (it replaces the XLA program that
#: the JAX package's ``jax_eval.compile_waveform`` jits, engine ``'xla'``)
trace_eval = _Kernel(
    'trace_eval', 'waveforms_tpu_torch/csrc/trace_eval.cu',
    'waveforms_tpu/ops/jax_eval.py:79', reference_trace.trace_eval,
    _launch_trace_eval, out_at=5)


KERNELS = (synth_dense, synth_panel, synth_sparse, synth_stack,
           synth_stack_seq, synth_dense_hi, synth_panel_hi, probe_health,
           probe_grid, probe_walker, probe_sparse_compact, iir_df2t,
           trace_eval)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    synth_dense.windowed_launches = 0
    synth_dense.shot_launches = 0
    synth_sparse.shot_launches = 0
    iir_df2t.state_launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
