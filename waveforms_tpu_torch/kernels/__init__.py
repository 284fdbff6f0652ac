"""Build, bind and launch the hand-written CUDA kernels.

The sources in ``waveforms_tpu_torch/csrc/`` compile with nvcc, at first
use, into one shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC csrc/synth_dense.cu csrc/synth_panel.cu

(no ``--use_fast_math``: it would change expf/sinf/division and flush
denormals).  The library goes to ``build/waveforms_tpu_torch/`` beside the
package, named by a hash of the sources, so an edited source rebuilds.

One wrapper per kernel: :data:`synth_dense` (K1, the dense grid) and
:data:`synth_panel` (K2, the panel walk).  A wrapper given tensors on the
CPU runs the kernel's plain version (:mod:`..ops.reference`); given CUDA
tensors it launches the kernel, checks the launch's ``cudaGetLastError()``
and raises on any failure -- it never falls back.  Each wrapper counts its
kernel launches in ``launches``.
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

from ..ops import reference

__all__ = ['synth_dense', 'synth_panel', 'load_library', 'library_path',
           'reset_launch_counts', 'launch_counts', 'KERNELS']

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
SOURCES = ('synth_dense.cu', 'synth_panel.cu')
HEADERS = ('synth_common.cuh',)
BUILD_DIR = _PKG.parent / 'build' / 'waveforms_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')

# largest dense-kernel tile (samples per thread block)
DENSE_TILE = 2048

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
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)       # atomic: concurrent builders never clash
    finally:
        if tmp.exists():
            tmp.unlink()
    return r.stdout + r.stderr


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
        lib.wf_synth_dense.argtypes = ([P] * 13 + [I] * 5 + [L, L, I]
                                       + [P, I, P, P])
        lib.wf_synth_dense.restype = I
        lib.wf_synth_panel.argtypes = ([P] * 12 + [I] * 5 + [L, L]
                                       + [P] * 5 + [I, I, I, L]
                                       + [P, I, P, P])
        lib.wf_synth_panel.restype = I
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


def _out_kind(out, scale, shape):
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {shape}")
    if out.dtype == torch.float32:
        return 0
    if out.dtype == torch.int16:
        if scale is None or scale.dtype != torch.float32:
            raise ValueError("int16 output needs a per-channel f32 scale")
        return 1
    raise ValueError(f"unsupported output dtype {out.dtype}")


def _raise_on(code, name):
    if code != 0:
        msg = load_library().wf_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


class _Kernel:
    """A kernel wrapper with its launch count."""

    def __init__(self, name, source, replaces, plain, launch):
        self.name = name
        self.source = source        # path in the repo
        self.replaces = replaces    # the TPU kernel, file:line
        self.plain = plain          # the plain PyTorch version
        self._launch = launch
        self.launches = 0

    def __call__(self, *args):
        out = args[-2]
        if out.device.type == 'cpu':
            return self.plain(*args)
        if out.device.type != 'cuda':
            raise ValueError(f"{self.name}: unsupported device {out.device}")
        self._launch(*args)
        self.launches += 1
        return out


def _dense_tile(d):
    """Largest power-of-two tile <= DENSE_TILE that divides the bucket, so
    that no tile straddles two buckets."""
    tile = DENSE_TILE
    if d.shape[1] > 1:
        while tile > 128 and d.bucket_samples % tile:
            tile //= 2
        if d.bucket_samples % tile:
            raise ValueError(f"bucket_samples {d.bucket_samples} must be a "
                             "multiple of 128")
    return tile


def _launch_dense(d, out, scale):
    C, NB, S, T, F = d.shape
    kind = _out_kind(out, scale, (C, d.n_samples))
    desc = _descriptors(d, dense=True)
    _check_cuda(dict(desc, out=out, **({'scale': scale} if kind else {})),
                out.device)
    if C > 65535:
        raise ValueError("at most 65535 channels per launch")
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.wf_synth_dense(
            *(t.data_ptr() for t in desc.values()), C, NB, S, T, F,
            d.n_samples, d.bucket_samples, _dense_tile(d), out.data_ptr(),
            kind, scale.data_ptr() if kind else None, stream)
    _raise_on(code, 'synth_dense')


def _launch_panel(d, work, out, scale):
    C, NB, S, T, F = d.shape
    kind = _out_kind(out, scale, (C, out.shape[1]))
    desc = _descriptors(d, dense=False)
    plan = {n: getattr(work, n) for n in
            ('start', 'work_t', 'work_o', 'work_s0', 'work_s1')}
    _check_cuda(dict(desc, out=out, **plan,
                     **({'scale': scale} if kind else {})), out.device)
    if C > 65535 or work.n_panels > 65535:
        raise ValueError("at most 65535 channels and panels per launch")
    if kind and NB > 1:
        raise ValueError("int16 panel output needs a single bucket")
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.wf_synth_panel(
            *(t.data_ptr() for t in desc.values()), C, NB, S, T, F,
            d.n_samples, d.bucket_samples,
            *(t.data_ptr() for t in plan.values()), work.Rs, work.P,
            work.n_panels, out.shape[1], out.data_ptr(), kind,
            scale.data_ptr() if kind else None, stream)
    _raise_on(code, 'synth_panel')


#: K1: ``synth_dense(dev, out, scale)`` fills out (C, n_samples)
synth_dense = _Kernel(
    'synth_dense', 'waveforms_tpu_torch/csrc/synth_dense.cu',
    'waveforms_tpu/ops/pallas_synth.py:583', reference.dense_walk,
    _launch_dense)

#: K2: ``synth_panel(dev, work, out, scale)`` fills out (C, window_samples)
synth_panel = _Kernel(
    'synth_panel', 'waveforms_tpu_torch/csrc/synth_panel.cu',
    'waveforms_tpu/ops/sparse_synth.py:476', reference.panel_walk,
    _launch_panel)

KERNELS = (synth_dense, synth_panel)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
