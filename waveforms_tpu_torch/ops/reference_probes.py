"""Plain PyTorch versions of the measurement probes (``csrc/probes.cu``).

Each computes, with the same f32 operations in the same order, what the
probe kernels of ``tools/tpu_capture.py`` compute: P4 ``2 * x``; P2 the
in-order sum of the touched table values broadcast into output blocks; P3
the seven walker bodies; P1 the worklist kernel's subtiles stored
compactly, one block per worklist item.  The CPU tests hold them to the
JAX probe kernels bit for bit (P1 within f32 noise), and ``chip_smoke.py``
holds the CUDA kernels to them on the card.
"""

from __future__ import annotations

import torch

from . import reference

__all__ = ['health', 'grid', 'walker', 'sparse_compact', 'WALKER_BODIES']

_F32 = torch.float32

#: P3's bodies in ``tools/tpu_capture.py``'s order, with the repetitions
#: each prices (``ns_per`` = (body - base) / reps)
WALKER_BODIES = (('base', 1), ('reads64', 64), ('cond16', 16),
                 ('switch16x3', 16), ('fori16', 16), ('veccond8', 8),
                 ('vecwork8', 8))


def health(x, out):
    """P4: ``out = 2 * x``."""
    return torch.mul(x, 2.0, out=out)


def grid(tables, wc, wo, n_ops, dyn_in, dyn_out, out):
    """P2 over ``out`` (n_blocks, Rs, 128): step i sums ``tables[r][idx, 0,
    0]`` for r = 0 .. n_ops - 1 from 0.0 in order (``idx = wc[i]`` when
    ``dyn_in``, else 0) and fills block ``wo[i]`` (``dyn_out``) or ``i``.
    Where several steps fill one block the last one lands, as on the TPU's
    sequential grid; blocks no step fills are left as they are."""
    K = wc.shape[0]
    idx = wc.to(torch.int64) if dyn_in else torch.zeros(
        K, dtype=torch.int64, device=wc.device)
    acc = torch.zeros(K, dtype=_F32, device=wc.device)
    for t in tables[:n_ops]:
        acc = acc + t[idx, 0, 0]
    dst = (wo.to(torch.int64) if dyn_out
           else torch.arange(K, device=wc.device))
    last = torch.full((out.shape[0],), -1, dtype=torch.int64,
                      device=wc.device)
    last.scatter_reduce_(0, dst, torch.arange(K, device=wc.device), 'amax')
    hit = torch.nonzero(last >= 0).squeeze(1)
    out[hit] = acc[last[hit]][:, None, None].expand(-1, *out.shape[1:])
    return out


def _walker_scalar(body, f, it, L):
    """A scalar body of P3 for every step at once: f (K, L) f32 and it
    (K, L) int32 are the steps' table rows -> (K,) f32."""
    acc = torch.zeros(f.shape[0], dtype=_F32, device=f.device)
    if body == 'base':
        return f[:, 0].clone()
    if body == 'reads64':
        for k in range(64):
            acc = acc + f[:, k]
    elif body in ('cond16', 'veccond8'):
        for k in range(16 if body == 'cond16' else 8):
            acc = torch.where(it[:, k] > 0, acc + f[:, k], acc)
    elif body == 'switch16x3':
        for k in range(16):
            s = it[:, k].clamp(0, 2)
            v = torch.where(s == 0, f[:, k],
                            torch.where(s == 1, f[:, k] * 2.0, f[:, k] + 1.0))
            acc = acc + v
    elif body == 'fori16':
        n = (it[:, 0] + 15).clamp(max=L)      # the kernel's trip count
        for j in range(int(n.max()) if n.numel() else 0):
            acc = torch.where(j < n, acc + f[:, j], acc)
    else:
        raise ValueError(f"unknown walker body {body!r}")
    return acc


def walker(body, wc, ftab, itab, out):
    """P3 body ``body`` (a name of :data:`WALKER_BODIES`) over ``out`` (K,
    Rs, 128): step i reads row ``wc[i]`` of ``ftab`` (C, 1, L) f32 and
    ``itab`` (C, 1, L) int32 and fills block i.  ``fori16`` runs
    ``min(it[0] + 15, L)`` trips (the JAX body reads past the row
    otherwise)."""
    K, Rs, lanes = out.shape
    L = ftab.shape[-1]
    rows = wc.to(torch.int64)
    f = ftab[rows, 0]
    it = itab[rows, 0]
    if body == 'vecwork8':
        row = torch.arange(Rs, device=out.device)[None, :, None]
        acc = torch.zeros((K, Rs, lanes), dtype=_F32, device=out.device)
        for k in range(8):
            acc = acc + torch.where(row >= it[:, k, None, None],
                                    f[:, k, None, None], 0.0)
        return out.copy_(acc)
    out.copy_(_walker_scalar(body, f, it, L)[:, None, None].expand_as(out))
    return out


def sparse_compact(d, work, out):
    """P1's compact variant of the worklist kernel: item k of ``work`` (a
    :class:`..ops.sparse_synth.SparseWork`, padding included) evaluates
    its Rs x 128 subtile over its segments ``[work_s0, work_s1)`` and
    stores it at ``out[k]`` (K, Rs, 128), f32.  Padding items (an empty
    segment range) store zeros."""
    K = work.work_c.shape[0]
    tile = work.Rs * 128
    flat = out.view(K, tile).zero_()
    reference._walk_items(
        d, [flat], work.work_c.to(torch.int64), work.work_b.to(torch.int64),
        work.work_t.to(torch.int64) * tile,
        torch.zeros(K, dtype=torch.int64, device=out.device),
        work.work_s0.to(torch.int64), work.work_s1.to(torch.int64), tile,
        orow=torch.arange(K, device=out.device))
    return out
