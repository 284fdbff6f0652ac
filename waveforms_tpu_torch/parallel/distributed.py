"""The multi-process runtime: a process group, and the exchanges of a mesh
that spans processes.

The port of the JAX package's multi-process path
(``tools/multiproc_smoke.py``: ``jax.distributed.initialize``,
``jax.process_count``, ``multihost_utils.process_allgather``) on
``torch.distributed``.  Each OS process owns some shards of a ('channel',
'time') mesh (:func:`.mesh.channel_mesh` after :func:`init_distributed`)
and launches only their kernels; whatever crosses a process boundary
crosses it through the helpers here, and nothing else does:

- :func:`all_reduce_sum`: a sum over every rank (the global mean, the
  demodulation's partial IQ sums);
- :func:`all_gather`: one equal-sized tensor from every rank (the IIR
  filter's boundary states; gloo needs equal sizes, so callers pad);
- :func:`all_to_all`: a flat piece of one dtype from every rank to every
  rank (the four-step FFT's transposes);
- :func:`gather_to`: blocks to one rank, point to point (a plane assembled
  for a check; the production step never calls it).

The backend is named by the caller, ``'gloo'`` or ``'nccl'``, with no
default that guesses and no fallback from one to the other.  Under gloo a
tensor on a card is copied to the host before the exchange and the result
back to the card after it: that copy is how gloo takes card tensors here.
Under nccl every tensor stays on the card, and a host tensor raises.

:data:`SENT` counts what this rank hands to the exchanges: ``bytes`` (a
tensor's bytes each time it enters a collective, padding included; for the
all-to-all and the gather, only the pieces bound for other ranks),
``calls`` and ``seconds`` (host clock, staging included).
:func:`reset_sent` sets them to 0.
"""

from __future__ import annotations

import datetime
import time

import torch

__all__ = ['BACKENDS', 'TIMEOUT', 'SENT', 'init_distributed', 'shutdown',
           'active', 'rank', 'world_size', 'backend', 'reset_sent',
           'all_reduce_sum', 'all_gather', 'all_to_all', 'gather_to']

BACKENDS = ('gloo', 'nccl')

#: how long a collective waits on a peer before the call fails: a dead
#: worker ends its peers' calls instead of hanging them
TIMEOUT = datetime.timedelta(minutes=3)

#: what this rank sent since the last :func:`reset_sent`
SENT = {'bytes': 0, 'calls': 0, 'seconds': 0.0}

_backend = {'name': None}


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: str, timeout: datetime.timedelta = TIMEOUT):
    """Join the process group: ``init_method`` ``tcp://localhost:<port>``,
    this process's ``rank`` of ``world_size``, ``backend`` ``'gloo'`` or
    ``'nccl'`` (required).  A peer that does not arrive, or stops
    answering, fails the call after ``timeout``."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _backend['name'] = backend
    return rank


def shutdown():
    """Leave the process group (nothing to do outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _backend['name'] = None


def active() -> bool:
    """Whether this process is in a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if active() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if active() else 1


def backend() -> str | None:
    return _backend['name'] if active() else None


def reset_sent():
    SENT.update(bytes=0, calls=0, seconds=0.0)


def _count(nbytes, t0):
    SENT['bytes'] += int(nbytes)
    SENT['calls'] += 1
    SENT['seconds'] += time.perf_counter() - t0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend exchanges it: real (a complex tensor as its
    (re, im) pairs), contiguous, and on the host under gloo; under nccl on
    the card, where a host tensor raises."""
    if not active():
        raise RuntimeError("no process group: call init_distributed first")
    if t.is_complex():
        t = torch.view_as_real(t)
    if backend() == 'nccl':
        if t.device.type != 'cuda':
            raise ValueError(f"nccl exchanges card tensors, got one on "
                             f"{t.device}")
        return t.contiguous()
    return t.detach().to('cpu').contiguous()


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An exchanged tensor back in ``like``'s dtype, on its device."""
    if like.is_complex():
        w = torch.view_as_complex(w)
    return w.to(like.device)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, on ``t``'s device (``t`` is not
    changed)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    w = _wire(t)
    if w.data_ptr() == t.data_ptr():
        w = w.clone()
    dist.all_reduce(w)
    out = _unwire(w, t)
    _count(t.numel() * t.element_size(), t0)
    return out


def all_gather(t: torch.Tensor) -> list:
    """Every rank's ``t`` (one shape and dtype on every rank), in rank
    order, on ``t``'s device."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    w = _wire(t)
    got = [torch.empty_like(w) for _ in range(world_size())]
    dist.all_gather(got, w)
    out = [_unwire(g, t) for g in got]
    _count(t.numel() * t.element_size(), t0)
    return out


def all_to_all(pieces: list, numels: list, like: torch.Tensor) -> list:
    """Send ``pieces[q]`` (a flat tensor of ``like``'s dtype, possibly
    empty) to rank q and receive ``numels[q]`` elements from each rank q
    -> the received flat pieces, in rank order, on ``like``'s device.  This
    rank's own piece is passed through unsent."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    me, n = rank(), world_size()
    if len(pieces) != n or len(numels) != n:
        raise ValueError(f"one piece and one count per rank ({n})")
    if pieces[me].numel() != numels[me]:
        raise ValueError("this rank's own piece and count disagree")
    empty = like.new_empty(0)
    send = [empty if q == me else p.reshape(-1)
            for q, p in enumerate(pieces)]
    w = _wire(torch.cat(send)).reshape(-1)
    per = 2 if like.is_complex() else 1       # (re, im) words an element
    in_splits = [per * s.numel() for s in send]
    out_splits = [0 if q == me else per * k for q, k in enumerate(numels)]
    out = w.new_empty(sum(out_splits))
    dist.all_to_all_single(out, w, out_splits, in_splits)
    got = []
    for q, part in enumerate(out.split(out_splits)):
        if q == me:
            got.append(pieces[me].reshape(-1))
        else:
            got.append(_unwire(part.reshape(-1, 2) if per == 2 else part,
                               like))
    _count(sum(s.numel() for s in send) * like.element_size(), t0)
    return got


def gather_to(items, dst: int, device=None):
    """Blocks to rank ``dst``, point to point, in the order of ``items``:
    each item ``(owner, tensor or None, shape, dtype)``, the same list on
    every rank (``tensor`` given on its owner).  -> on ``dst`` the list of
    every item's tensor on ``device`` (default: each its own device where
    it is local, else the first local tensor's); on any other rank
    None."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    me = rank()
    if device is None:
        device = next((t.device for o, t, _, _ in items
                       if o == me and t is not None), torch.device('cpu'))
    out, sent = [], 0
    for owner, t, shape, dtype in items:
        if owner == me:
            if me == dst:
                out.append(t.to(device))
            else:
                w = _wire(t)
                dist.send(w, dst)
                sent += t.numel() * t.element_size()
        elif me == dst:
            like = torch.empty(0, dtype=dtype, device=device)
            w = torch.empty(tuple(shape) + ((2,) if dtype.is_complex else ()),
                            dtype=_REAL.get(dtype, dtype),
                            device=device if backend() == 'nccl' else 'cpu')
            dist.recv(w, owner)
            out.append(_unwire(w, like))
    _count(sent, t0)
    return out if me == dst else None


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
