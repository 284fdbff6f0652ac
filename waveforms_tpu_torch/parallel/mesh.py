"""Multi-device synthesis: the (channels, samples) plane over a mesh.

The port of the JAX package's ``waveforms_tpu/parallel/mesh.py``.  The
synthesis problem is embarrassingly parallel in both axes -- basis
evaluation is pointwise in t, so sharding needs no halos: the 'channel' axis
splits the descriptor rows, and the 'time' axis splits the output, with
each shard's global sample offset handed to its kernel.

A :class:`Mesh` is a grid of torch devices that may name one device more
than once, so a (4, 2) mesh runs on one GPU, each shard's kernel launched
on it in turn, and on a host with several GPUs the same code places the
shards on ``cuda:0..n-1``.  In one process it is single-controller, as the
JAX mesh is: one process drives every shard.  After
:func:`.distributed.init_distributed` a mesh may span processes, as a JAX
mesh does under ``jax.distributed``: :func:`channel_mesh` takes each
process's own devices and lays out every rank's in rank order (JAX's global
device list), and each shard knows the rank that owns it
(:attr:`Mesh.owners`).  Every process lowers the whole schedule and shards
it alike (the lowering is deterministic), and launches only its own shards'
kernels.  Where JAX returns one global array sharded ``P('channel',
'time')``, the port returns a :class:`ShardedPlane`: the grid of local
blocks, each on its shard's device (None for another process's shard),
which the sharded pipeline (:mod:`.pipeline`) takes without a gather.

Not carried over: the opcode remap of the TPU kernel's branch table
(``op_remap`` / ``_compact_ops``): the CUDA kernels switch on the
lowering's own opcodes.  And the TPU's descriptor budget
(``LoweredSchedule.pallas_ok``) refuses nothing here, as on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.lowering import LoweredSchedule, UnsupportedFactor
from ..ops.synth import (DeviceSchedule, dac_scale_tensor,
                         default_rows_per_tile, resolve_device,
                         validate_out_mode)

__all__ = ['Mesh', 'ShardedPlane', 'channel_mesh', 'shard_schedule',
           'synthesize_sharded', 'synthesize_on_mesh']


def canonical_device(device) -> torch.device:
    """``device`` as a torch device with its index ('cuda' -> 'cuda:k', the
    current card), so that two spellings of one device compare equal;
    ``'cuda'`` with no GPU raises."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class Mesh:
    """A ('channel', 'time') grid of torch devices.

    ``devices`` is an (nc, nt) object array of ``torch.device``; a device
    may appear more than once.  ``owners`` is the rank of the process that
    owns each shard (default: all this process's), and ``rank`` this
    process's; a shard of another process has no device here (None).
    ``shape`` maps each axis name to its size, as a JAX ``Mesh.shape``
    does."""

    axis_names = ('channel', 'time')

    def __init__(self, devices, owners=None, rank: int = 0):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("a mesh is an (n_channel, n_time) grid")
        self.owners = (np.full(self.devices.shape, rank, np.int64)
                       if owners is None else np.asarray(owners, np.int64))
        if self.owners.shape != self.devices.shape:
            raise ValueError("one owner a shard")
        self.rank = int(rank)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i, j) -> torch.device:
        """Shard (i, j)'s device (None for another process's shard)."""
        return self.devices[i, j]

    def is_local(self, i, j) -> bool:
        """Whether this process owns shard (i, j)."""
        return bool(self.owners[i, j] == self.rank)

    @staticmethod
    def spanning(owners):
        """``owners`` (shards' ranks) as an array where they name more than
        one process, else None: the one test of whether shards span
        processes, and so whether what is made of them needs collectives
        (a plane's ``owners``, the distributed FFT's exchange)."""
        owners = np.asarray(owners, np.int64)
        return owners if (owners != owners.flat[0]).any() else None

    @property
    def plane_owners(self):
        """``owners`` for the planes of a mesh that spans processes, else
        None (a plane in one process needs no collective)."""
        return Mesh.spanning(self.owners)

    @property
    def spans_processes(self) -> bool:
        return self.plane_owners is not None

    @property
    def local(self) -> list:
        """This process's shards (i, j), in mesh order."""
        return [(int(i), int(j)) for i, j in zip(*np.nonzero(
            self.owners == self.rank))]

    def __repr__(self):
        devs = [str(d) if o == self.rank else f'rank{o}'
                for d, o in zip(self.devices.flat, self.owners.flat)]
        return f"Mesh({self.shape}, {devs})"


def channel_mesh(n_channel: int | None = None, n_time: int = 1,
                 devices=None, order=None) -> Mesh:
    """Build a ('channel', 'time') mesh over ``devices`` (row-major).

    ``devices`` defaults to every visible GPU, and raises when torch sees
    none (nothing carries on on the CPU unasked); pass ``['cpu'] * 8`` for
    the plain versions, or ``['cuda:0'] * 8`` for a (4, 2) mesh on one
    card.  ``n_channel`` defaults to the devices over ``n_time``.

    In a process group of several processes (:func:`.distributed.
    init_distributed`; every rank calls this alike) ``devices`` are this
    process's own, and the mesh's device list is every rank's, in rank
    order, as ``jax.devices()`` lists them under ``jax.distributed``.
    ``order`` permutes that list (the flat indices of its devices, in the
    mesh's row-major order), as JAX's ``devices=`` takes any order of the
    global devices: on 2 processes of 4 devices each, ``order=[0, 4, 1, 5,
    2, 6, 3, 7]`` makes a (4, 2) mesh whose time shard r is rank r's."""
    from . import distributed
    if devices is None:
        if not torch.cuda.is_available() or not torch.cuda.device_count():
            raise RuntimeError(
                "channel_mesh() takes every visible GPU, and torch sees "
                "none: pass devices=['cpu'] * n for the plain versions")
        devices = [f'cuda:{k}' for k in range(torch.cuda.device_count())]
    devs = [canonical_device(d) for d in devices]
    me = distributed.rank()
    if distributed.world_size() > 1:
        n = torch.tensor([len(devs)], device=devs[0] if (
            distributed.backend() == 'nccl') else 'cpu')
        counts = [int(c) for c in distributed.all_gather(n)]
        flat = [(r, k) for r, c in enumerate(counts) for k in range(c)]
    else:
        flat = [(me, k) for k in range(len(devs))]
    if order is not None:
        order = [int(g) for g in order]
        if sorted(order) != list(range(len(flat))):
            raise ValueError(f"order must permute the {len(flat)} devices")
        flat = [flat[g] for g in order]
    if n_channel is None:
        n_channel = len(flat) // n_time
    if n_channel < 1 or n_time < 1 or n_channel * n_time != len(flat):
        raise ValueError(f"{len(flat)} devices do not make a "
                         f"({n_channel}, {n_time}) mesh")
    grid = np.empty((n_channel, n_time), dtype=object)
    owners = np.empty((n_channel, n_time), np.int64)
    for k, (r, d) in enumerate(flat):
        grid[k // n_time, k % n_time] = devs[d] if r == me else None
        owners[k // n_time, k % n_time] = r
    return Mesh(grid, owners, me)


def _pad_channels(arr: np.ndarray, c_pad: int) -> np.ndarray:
    if arr.shape[0] == c_pad:
        return arr
    pad = np.zeros((c_pad - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _pad_axis(arr: np.ndarray, axis: int, size: int) -> np.ndarray:
    if arr.shape[axis] == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, widths)


@dataclasses.dataclass
class ShardedPlane:
    """A (C, N) result held shard by shard: ``blocks[i][j]`` is the block
    of channel shard i and time shard j, on its shard's device, cut to the
    plane's extent (silent padding channels and samples past the end are
    not in it; a shard wholly past the end holds an empty block).  A
    (n_shots, C, N) stack of shots split over a mesh's devices is held the
    same way, as an (n_devices, 1) grid of blocks along the shot axis.

    On a mesh that spans processes, ``owners[i][j]`` is the rank that holds
    block (i, j) (None in one process) and ``block_shapes[i][j]`` its
    shape, known to every rank; another process's block is None here.
    ``gather`` and ``mean`` are then collectives: every rank calls them."""
    blocks: list
    shape: tuple
    dtype: torch.dtype
    owners: np.ndarray | None = None
    block_shapes: list | None = None

    def local_blocks(self) -> list:
        """This process's blocks, in mesh order."""
        return [b for row in self.blocks for b in row if b is not None]

    def gather(self, device=None, dst: int = 0) -> torch.Tensor | None:
        """The whole result on ``device`` (default: the first local
        block's).  Across processes it is assembled on rank ``dst``, which
        receives the other ranks' blocks, and every other rank gets None;
        only tests and checks call it, never the production step."""
        if self.owners is None:
            device = self.blocks[0][0].device if device is None else device
            return torch.cat([torch.cat([b.to(device) for b in row], -1)
                              for row in self.blocks], 0)
        from . import distributed
        owners = np.asarray(self.owners)
        items = [(int(owners[i, j]), b, self.block_shapes[i][j], self.dtype)
                 for i, row in enumerate(self.blocks)
                 for j, b in enumerate(row)]
        got = distributed.gather_to(items, dst, device)
        if got is None:
            return None
        nt = len(self.blocks[0])
        return torch.cat([torch.cat(got[i * nt:(i + 1) * nt], -1)
                          for i in range(len(self.blocks))], 0)

    def mean(self) -> float:
        """The mean of every element of the result (float64 sums): a sum
        over every process's blocks where the plane spans processes, the
        cross-process collective of JAX's ``jnp.mean`` of a global
        array."""
        from . import distributed
        local = self.local_blocks()
        device = local[0].device if local else torch.device('cpu')
        total = torch.zeros((), dtype=torch.float64, device=device)
        for b in local:
            total = total + b.to(device).double().sum()
        if self.owners is not None:
            total = distributed.all_reduce_sum(total)
        return float(total) / float(np.prod(self.shape))

    def map(self, fn) -> 'ShardedPlane':
        """Apply ``fn`` to every local block (a view or a new tensor of the
        same shape on the same device) -> a plane of the results."""
        blocks = [[None if b is None else fn(b) for b in row]
                  for row in self.blocks]
        dtype = fn(torch.empty(0, dtype=self.dtype)).dtype
        return ShardedPlane(blocks, self.shape, dtype, self.owners,
                            self.block_shapes)


class ShardRun:
    """The kernel launches of one sharded call, into local blocks allocated
    up front: ``run()`` launches every local shard in mesh order (again, if
    called again: the time of the launches alone), ``plane()`` is the
    result.  ``grid`` is the (rows, columns) of blocks; each block is (the
    shard's ``cs`` channels incl. padding, its samples up to the plane's
    end), column j ``widths[j]`` samples wide; ``owners`` the rank of each
    shard (None: all this process's).  Another process's shard is never
    added and stays None."""

    def __init__(self, grid, n_channels: int, cs: int, dtype, widths,
                 owners=None):
        self.n_channels, self.cs, self.dtype = n_channels, cs, dtype
        self.widths, self.owners = list(widths), owners
        self.blocks = [[None] * grid[1] for _ in range(grid[0])]
        self.calls = []

    def add(self, i, j, block, launch=None):
        self.blocks[i][j] = block
        if launch is not None:
            self.calls.append(launch)

    def run(self) -> 'ShardRun':
        for launch in self.calls:
            launch()
        return self

    def plane(self) -> ShardedPlane:
        keep = [max(0, min(self.cs, self.n_channels - i * self.cs))
                for i in range(len(self.blocks))]
        blocks = [[None if b is None else b[:k] for b in row]
                  for row, k in zip(self.blocks, keep)]
        shapes = [[(k, w) for w in self.widths] for k in keep]
        return ShardedPlane(blocks, (self.n_channels, sum(self.widths)),
                            self.dtype, self.owners, shapes)


def time_windows(n_samples: int, span: int, nt: int):
    """Shard j's samples [a, b) of ``n_samples``: a = j * span, cut at the
    end (empty for a shard wholly past it)."""
    return [(min(j * span, n_samples), min((j + 1) * span, n_samples))
            for j in range(nt)]


def shard_schedule(low: LoweredSchedule, mesh: Mesh,
                   nb_pad: int | None = None):
    """Each shard's descriptors on its device -> (grid, c_pad), ``grid[i][j]``
    the :class:`~..ops.synth.DeviceSchedule` of shard (i, j).

    Channels pad up to a multiple of the channel-axis size (padded channels
    have zero segments and synthesize to silence); shard i holds channels
    [i * cs, (i + 1) * cs) of that, so its descriptor bytes are 1/nc of the
    whole.  With ``nb_pad`` set, the bucket axis pads to that count and
    time shard j holds buckets [j * nb_pad / nt, (j + 1) * nb_pad / nt),
    exactly the descriptor windows of its sample slice; its bucket 0 is the
    schedule's bucket ``j * nb_pad / nt`` (K1's ``bucket0``).  Each shard
    keeps the schedule's global ``n_samples``: the kernels take the global
    time of every sample.  Shards on one device with the same slice share
    their tensors.  Only this process's shards are uploaded; another
    process's stay None."""
    C, NB, S, T, F = low.shape
    nc, nt = mesh.devices.shape
    c_pad = -(-C // nc) * nc
    cs = c_pad // nc
    sliced = nb_pad is not None and nb_pad > 1
    nb = nb_pad if sliced else NB
    nbl = nb // nt if sliced else NB
    names = ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op', 'power',
             'shift_hi', 'q32', 'args') + (
        ('amp_im',) if low.amp_im is not None else ())
    padded = {n: _pad_axis(_pad_channels(getattr(low, n), c_pad), 1, nb)
              for n in names}
    clip_min = _pad_channels(low.clip_min, c_pad)
    clip_max = _pad_channels(low.clip_max, c_pad)
    made = {}
    grid = [[None] * nt for _ in range(nc)]
    for i in range(nc):
        rows = slice(i * cs, (i + 1) * cs)
        for j in range(nt):
            if not mesh.is_local(i, j):
                continue
            b0 = j * nbl if sliced else 0
            key = (i, b0, str(mesh.device(i, j)))
            if key not in made:
                part = {n: a[rows, b0:b0 + nbl] for n, a in padded.items()}
                sub = dataclasses.replace(
                    low, clip_min=clip_min[rows], clip_max=clip_max[rows],
                    **part)
                made[key] = DeviceSchedule(sub, mesh.device(i, j))
            grid[i][j] = made[key]
    return grid, c_pad


def _shard_scales(dt, dac_scale, C, c_pad, mesh):
    """Each channel shard's slice of the (C,) int16 scale, on each local
    shard's device -> a grid, or None for a float output."""
    scale = dac_scale_tensor(dt, dac_scale, C, 'cpu')
    if scale is None:
        return None
    scale = torch.from_numpy(_pad_channels(scale.numpy(), c_pad))
    nc, nt = mesh.devices.shape
    cs = c_pad // nc
    return [[scale[i * cs:(i + 1) * cs].to(mesh.device(i, j))
             if mesh.is_local(i, j) else None
             for j in range(nt)] for i in range(nc)]


def dense_shards(low: LoweredSchedule, mesh: Mesh,
                 rows_per_tile: int | None = None, out_dtype=None,
                 dac_scale=32767.0) -> ShardRun:
    """The launches of :func:`synthesize_sharded`, not yet run."""
    from .. import kernels
    C, NB, S, T, F = low.shape
    pair = low.amp_im is not None
    dt, _ = validate_out_mode(out_dtype, C, dac_scale, 'cpu', pair=pair)
    nc, nt = mesh.devices.shape
    n = low.n_samples
    if rows_per_tile is None:
        rows_per_tile = default_rows_per_tile(-(-n // nt),
                                              low.bucket_samples, NB)
    R = rows_per_tile
    if NB > 1:
        # bucketed: whole buckets per time shard, so that every local
        # tile's bucket window lives on its own shard
        if low.bucket_samples % (R * 128):
            raise ValueError("bucket_samples must be a multiple of the tile")
        nb_pad = -(-NB // nt) * nt
        rows_local = (nb_pad // nt) * (low.bucket_samples // 128)
        grid, c_pad = shard_schedule(low, mesh, nb_pad=nb_pad)
        bucket0 = [j * (nb_pad // nt) for j in range(nt)]
    else:
        n_rows = -(-n // 128)
        n_rows = -(-n_rows // (R * nt)) * (R * nt)
        rows_local = n_rows // nt
        grid, c_pad = shard_schedule(low, mesh)
        bucket0 = [0] * nt
    scales = _shard_scales(dt, dac_scale, C, c_pad, mesh)
    cs = c_pad // nc
    windows = time_windows(n, rows_local * 128, nt)
    run = ShardRun(mesh.devices.shape, C, cs, dt,
                   [b - a for a, b in windows], mesh.plane_owners)
    for i in range(nc):
        for j, (a, b) in enumerate(windows):
            if not mesh.is_local(i, j):
                continue
            dev = grid[i][j]
            out = torch.empty((cs, b - a), dtype=dt, device=dev.device)
            scale = None if scales is None else scales[i][j]
            # the window of shard j: samples [a, b), cut at the schedule's
            # end, where the TPU grid runs on past it into padding rows
            launch = (None if b == a else
                      lambda dev=dev, out=out, scale=scale, a=a, b=b,
                      b0=bucket0[j]: kernels.synth_dense(
                          dev, out, scale, a, b - a, b0))
            run.add(i, j, out, launch)
    return run


def synthesize_sharded(low: LoweredSchedule, mesh: Mesh,
                       rows_per_tile: int | None = None, out_dtype=None,
                       dac_scale=32767.0) -> ShardedPlane:
    """Synthesize a lowered schedule over a ('channel', 'time') mesh with
    the dense kernel (K1), one launch per shard -> :class:`ShardedPlane`.

    Shard (i, j) launches K1 over its channel block and its window of
    ``rows_per_tile``-row tiles from ``row0 = j * rows_local * 128``, as the
    JAX package's ``synthesize_sharded`` lays the shards out; a bucketed
    schedule shards whole buckets along 'time', each shard holding its
    slice of the bucket axis (``bucket0``).  ``out_dtype`` and
    ``dac_scale`` as on one device (int16 codes with a scalar or
    per-channel scale, bf16 / f16); a ``part='complex'`` lowering gives
    complex64.  Each shard's block equals the same samples of the
    single-device kernel's output bit for bit.  On a mesh that spans
    processes each process launches its own shards only."""
    return dense_shards(low, mesh, rows_per_tile, out_dtype,
                        dac_scale).run().plane()


def synthesize_on_mesh(channels, start, stop, sample_rate, mesh: Mesh,
                       part: str = 'real', rows_per_tile: int | None = None,
                       out_dtype=None, dac_scale=32767.0):
    """Lower, shard and synthesize in one call -> :class:`ShardedPlane`.

    Routes as the JAX package's ``synthesize_on_mesh``, with the thresholds
    of the mesh's devices' :class:`..ops.routes.RouteRule` (the JAX
    package's on CPU devices, the H100's on CUDA devices; the
    single-device router's pieces, :func:`..ops.routes.facts`,
    :func:`..ops.routes.stack_first`, :func:`..ops.routes.takes_worklist`
    and :func:`..ops.routes.stack_wins`): a many-narrow-pulse schedule
    (``stack_first``, no wide instance) the sharded stacked-table kernel
    (K6); else below the panel occupancy the sharded panel kernel (K2; the
    sharded worklist kernel K7 where the panel kernel refuses the output
    mode); below the worklist bound K7; under the JAX rule a winning
    stack plan K6; else the dense kernel (K1).  ``rows_per_tile`` forces
    the dense route, as in JAX.  The TPU's panel worklist budget does not
    refuse the panel route here, and a schedule over the TPU's descriptor
    budget runs on K1 where JAX raises (on CUDA devices that budget steers
    nothing)."""
    from ..ops import sparse_synth, stack_seq
    from ..ops.lowering import lower_schedule
    from ..ops.routes import (facts, rule_for, stack_first, stack_wins,
                              store_kind, takes_worklist)
    from ..ops.sparse_synth import build_sparse_plan
    from ..ops.stack_synth import build_stack_plan

    rule = rule_for(next((d for d in mesh.devices.flat if d is not None),
                         None))
    low = lower_schedule(channels, start, stop, sample_rate, part=part)
    budget_ok = low.pallas_ok or not rule.tpu
    prefer_stack = False
    memo = []                       # build_stack_plan is O(instances)
    if budget_ok and rows_per_tile is None:
        try:
            plan = build_sparse_plan(low)
            occ, small, band = facts(low, plan, rule)
            if part == 'real' and stack_first(occ, small, band):
                memo.append(build_stack_plan(low))
                prefer_stack = (memo[0] is not None and memo[0].wide is None
                                and stack_wins(memo[0], rule))
            if not prefer_stack and occ < rule.panel_occ:
                try:
                    return sparse_synth.synthesize_panels_sharded(
                        low, mesh, plan=plan, out_dtype=out_dtype,
                        dac_scale=dac_scale)
                except UnsupportedFactor:
                    pass               # a narrowed multi-bucket store: K7
            if not prefer_stack and (
                    takes_worklist(occ, band, store_kind(out_dtype,
                                                        part == 'complex'))
                    or occ < rule.panel_occ):
                return sparse_synth.synthesize_sparse_sharded(
                    low, mesh, plan=plan, out_dtype=out_dtype,
                    dac_scale=dac_scale)
        except UnsupportedFactor:
            pass
    if part == 'real' and rows_per_tile is None and (rule.tpu
                                                     or prefer_stack):
        splan = memo[0] if memo else build_stack_plan(low)
        # the stacked-table launch has no dense-residual arm, so wide
        # instances disqualify up front
        if splan is not None and splan.wide is None and (
                stack_wins(splan, rule) or not budget_ok):
            try:
                return stack_seq.synthesize_stack_sharded(
                    channels, start, stop, sample_rate, mesh,
                    out_dtype=out_dtype, dac_scale=dac_scale)
            except UnsupportedFactor:
                pass       # channels that do not split, a per-channel scale
    return synthesize_sharded(low, mesh, rows_per_tile=rows_per_tile,
                              out_dtype=out_dtype, dac_scale=dac_scale)
