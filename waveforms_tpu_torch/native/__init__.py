"""The C++ host layer: the lowering walker and the host float64 engine.

Two sources beside this file, the JAX package's ``native/`` carried over
(only their comments differ):

* ``lowerext.cpp``, a CPython extension: walks a channel's IR tuples and
  emits the flat factor descriptors of :mod:`..ops.lowering`
  (:func:`lower_channel_flat`), about ten times faster than the Python
  path on many-pulse schedules.  A channel it declines (a factor it does
  not take, such as a Hermite order given as a float, or malformed IR)
  gives None, and that channel lowers on the Python path into the same
  flat assembly (which raises its own error where it cannot lower either).
* ``wavecore.cpp``, a ctypes library: :func:`synthesize_native` runs a
  ``LoweredSchedule``'s descriptor program on the CPU in float64,
  multithreaded over channels (``synthesize(..., engine='native')``).

Both build with g++ at first use into ``build/waveforms_tpu_torch/`` beside
the package, each named by a hash of its source, its flags and what
``-march=native`` means on this host (and, for the extension, the Python
ABI), so an edited source or another CPU rebuilds.  A build goes to a
per-process temporary name and is renamed into place, so concurrent
processes never clash.  The flags are the JAX package's:

    g++ -O3 -march=native -ffast-math -fopenmp -fPIC -c wavecore.cpp
    g++ -shared -fopenmp wavecore.o -lmvec -lm      (no -ffast-math)
    g++ -O3 -march=native -shared -fPIC -I<python include> lowerext.cpp

``-ffast-math`` at the link would embed ``crtfastmath.o``, which sets
FTZ/DAZ for the whole process when the library loads and would flush
every float64 subnormal of torch and numpy on the CPU.

There is no fallback: a failed build raises ``RuntimeError`` with g++'s
output at the first call that needs the library, and at every later one.
:func:`lower_counts` counts the channels the walker lowered and those it
declined to the Python path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = ['lower_available', 'lower_channel_flat', 'available',
           'build_error', 'synthesize_native', 'lower_counts',
           'reset_lower_counts', 'library_paths']

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / 'wavecore.cpp'
_LOWER_SRC = _HERE / 'lowerext.cpp'
BUILD_DIR = _HERE.parent.parent / 'build' / 'waveforms_tpu_torch'
#: the C++ compiler, found on PATH
CXX = 'g++'
CORE_FLAGS = ('-O3', '-march=native', '-ffast-math', '-fopenmp', '-fPIC')
CORE_LINK = ('-shared', '-fopenmp')
CORE_LIBS = ('-lmvec', '-lm')
LOWER_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None
_lower_mod = None
_lower_error: str | None = None
_counts = {'walker': 0, 'python': 0}


def _cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: the native host layer "
            f"(waveforms_tpu_torch/native) builds from source at first use")
    return found


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        msg = f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stderr}"
        if 'gomp' in r.stderr:
            msg += ("\nlibgomp (GCC's OpenMP runtime, for -fopenmp) is "
                    "missing on this host")
        raise RuntimeError(msg)


@functools.lru_cache(maxsize=None)
def _native_target(cxx: str) -> str:
    """The target flags that ``-march=native`` expands to on this host."""
    r = subprocess.run([cxx, '-march=native', '-###', '-E', '-x', 'c++',
                        os.devnull], capture_output=True, text=True)
    return ' '.join(tok for tok in r.stderr.replace('"', ' ').split()
                    if tok.startswith(('-m', '--param')))


def _target(stem: str, src: Path, flags, cxx: str, extra: str = '') -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(' '.join(flags).encode())
    h.update(_native_target(cxx).encode())
    h.update(extra.encode())
    return BUILD_DIR / f'{stem}_{h.hexdigest()[:16]}.so'


def _build(path: Path, steps) -> None:
    """Run ``steps(tmp, obj)``'s commands into per-process names, then rename
    the library into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.stem}.{os.getpid()}.so.tmp')
    obj = path.with_name(f'{path.stem}.{os.getpid()}.o')
    try:
        for cmd in steps(str(tmp), str(obj)):
            _run(cmd)
        os.replace(tmp, path)
    finally:
        for leftover in (tmp, obj):
            try:
                os.unlink(leftover)
            except OSError:
                pass


def _core_path(cxx: str) -> Path:
    return _target('libwavecore', _SRC,
                   CORE_FLAGS + CORE_LINK + CORE_LIBS, cxx)


def _lower_path(cxx: str) -> Path:
    return _target('_lowerext', _LOWER_SRC, LOWER_FLAGS, cxx,
                   sys.version + str(sysconfig.get_config_var('EXT_SUFFIX')))


def _load():
    """The wavecore library, built at first use; raises on failure."""
    global _lib, _lib_error
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                cxx = _cxx()
                path = _core_path(cxx)
                if not path.exists():
                    _build(path, lambda tmp, obj: (
                        [cxx, *CORE_FLAGS, '-c', str(_SRC), '-o', obj],
                        [cxx, *CORE_LINK, '-o', tmp, obj, *CORE_LIBS]))
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as exc:
                    hint = (" (libgomp, GCC's OpenMP runtime, is missing)"
                            if 'gomp' in str(exc) else '')
                    raise RuntimeError(f"loading {path.name}: {exc}{hint}")
                i32, i64 = ctypes.c_int32, ctypes.c_int64
                ip, fp, dp = (ctypes.POINTER(t) for t in (
                    ctypes.c_int32, ctypes.c_float, ctypes.c_double))
                lib.wavecore_synthesize.argtypes = (
                    [ip] * 4 + [fp] + [ip] * 4 + [fp, dp, fp] + [i32] * 6
                    + [i64] * 2 + [dp, fp, dp, i32])
                lib.wavecore_synthesize.restype = None
                lib.wavecore_version.argtypes = []
                lib.wavecore_version.restype = ctypes.c_int32
                _lib = lib
            except (RuntimeError, OSError) as exc:
                _lib_error = f"building the native engine: {exc}"
        if _lib is None:
            raise RuntimeError(_lib_error)
        return _lib


def _load_lower():
    """The lowering extension, built at first use; raises on failure."""
    global _lower_mod, _lower_error
    with _lock:
        if _lower_mod is None and _lower_error is None:
            try:
                cxx = _cxx()
                path = _lower_path(cxx)
                if not path.exists():
                    inc = sysconfig.get_paths()['include']
                    _build(path, lambda tmp, obj: (
                        [cxx, *LOWER_FLAGS, f'-I{inc}', str(_LOWER_SRC),
                         '-o', tmp],))
                # the module name's last part gives PyInit__lowerext
                spec = importlib.util.spec_from_file_location(
                    f'{__name__}._lowerext', path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _lower_mod = mod
            except (RuntimeError, OSError, ImportError) as exc:
                _lower_error = f"building the lowering walker: {exc}"
        if _lower_mod is None:
            raise RuntimeError(_lower_error)
        return _lower_mod


def library_paths() -> dict:
    """Where each library is (or would be) built on this host."""
    cxx = _cxx()
    return {'wavecore': _core_path(cxx), 'lowerext': _lower_path(cxx)}


def lower_available() -> bool:
    """True if the lowering walker built (or builds now) on this host."""
    try:
        _load_lower()
    except RuntimeError:
        return False
    return True


def lower_counts() -> dict:
    """Channels lowered by the walker and declined to the Python path since
    the last :func:`reset_lower_counts`."""
    return dict(_counts)


def reset_lower_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def lower_channel_flat(pieces, grid, start, dt, want_imag):
    """Native channel lowering -> flat numpy arrays, or None when the
    channel needs the Python path.

    Returns (seg_lo, seg_hi, seg_nterm, term_amp, term_nfac, f_op, f_pw,
    f_sh, f_q32(n,4), f_args(n,12), ext(float64)).  ``ext`` holds this
    channel's float64 side-buffer blocks (multi-tone DRAG coefficient
    tables) with CHANNEL-LOCAL offsets in args[:, 7]; the schedule assembler
    rebases them into the shared schedule buffer.  Raises RuntimeError if
    the walker does not build.
    """
    mod = _load_lower()
    res = mod.lower_channel(list(pieces), memoryview(grid), float(start),
                            float(dt), int(want_imag))
    if res is None:
        _counts['python'] += 1
        return None
    _counts['walker'] += 1
    (b_lo, b_hi, b_nt), (b_amp, b_nf), (b_op, b_pw, b_sh, b_q, b_a), b_x = res
    seg_lo = np.frombuffer(b_lo, np.int64)
    seg_hi = np.frombuffer(b_hi, np.int64)
    seg_nt = np.frombuffer(b_nt, np.int32)
    t_amp = np.frombuffer(b_amp, np.float32)
    t_nf = np.frombuffer(b_nf, np.int32)
    f_op = np.frombuffer(b_op, np.int32)
    f_pw = np.frombuffer(b_pw, np.int32)
    f_sh = np.frombuffer(b_sh, np.int32)
    f_q = np.frombuffer(b_q, np.int32).reshape(-1, 4)
    f_a = np.frombuffer(b_a, np.float32).reshape(-1, 12)
    ext = np.frombuffer(b_x, np.float64)
    return seg_lo, seg_hi, seg_nt, t_amp, t_nf, f_op, f_pw, f_sh, f_q, f_a, \
        ext


def available() -> bool:
    """True if the native engine built (or builds now) on this host."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def build_error() -> str | None:
    """Why the native engine or the lowering walker did not build, or
    None."""
    available()
    lower_available()
    return _lib_error or _lower_error


def synthesize_native(low, n_threads: int = 0) -> np.ndarray:
    """Synthesize a LoweredSchedule on the CPU -> (C, N) float64.

    Schedules lowered with ``part='complex'`` (carrying an ``amp_im``
    plane) run in pair mode -- one factor-product pass scaled by both
    amplitude planes -- and return complex128.
    ``n_threads=0`` uses the OpenMP default (all cores).
    """
    lib = _load()

    from ..ops.lowering import W_ARGS

    C, NB, Sb, T, F = low.shape
    pair = getattr(low, 'amp_im', None) is not None
    out = np.empty((C, low.n_samples), dtype=np.float64)
    out_im = np.empty((C, low.n_samples), dtype=np.float64) if pair else None

    clip = np.stack([low.clip_min, low.clip_max], axis=1)
    # contiguous, correctly-typed holders kept alive for the call duration
    i32s = [np.ascontiguousarray(x, dtype=np.int32) for x in
            (low.seg_lo, low.seg_hi, low.nterm, low.nfac, low.op,
             low.power, low.shift_hi, low.q32)]
    f32s = [np.ascontiguousarray(x, dtype=np.float32) for x in
            (low.amp, low.args, clip)]
    amp_im = (np.ascontiguousarray(low.amp_im, dtype=np.float32)
              if pair else None)
    ext = np.ascontiguousarray(
        low.ext if low.ext is not None and low.ext.size else np.zeros(1),
        dtype=np.float64)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def dp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    seg_lo, seg_hi, nterm, nfac, op, power, shift_hi, q32 = i32s
    amp, args, clipf = f32s
    lib.wavecore_synthesize(
        ip(seg_lo), ip(seg_hi), ip(nterm), ip(nfac), fp(amp), ip(op),
        ip(power), ip(shift_hi), ip(q32), fp(args), dp(ext), fp(clipf),
        ctypes.c_int32(C), ctypes.c_int32(NB), ctypes.c_int32(Sb),
        ctypes.c_int32(T), ctypes.c_int32(F), ctypes.c_int32(W_ARGS),
        ctypes.c_int64(low.n_samples), ctypes.c_int64(low.bucket_samples),
        dp(out),
        fp(amp_im) if pair else None,
        dp(out_im) if pair else None,
        ctypes.c_int32(n_threads))
    if pair:
        return out + 1j * out_im
    return out
