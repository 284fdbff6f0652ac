"""Multi-device synthesis over a ('channel', 'time') mesh with the
PyTorch/CUDA port.

The mesh here is eight shards of one device (``channel_mesh(4, 2,
devices=[device] * 8)``): on a card each shard is a launch of its own
kernel on its slice of the plane; ``--device cpu`` runs the plain PyTorch
versions.  A host with several cards takes them with ``channel_mesh(4,
2)``.  Three surfaces:

1. ``synthesize_on_mesh`` -- the routed entry point (the worklist, stack
   or dense kernel by the device's rule, mirroring the single-device
   engine), also in int16 DAC codes;
2. ``synthesize_stack_sharded`` -- vstack-class schedules, each shard a
   slice of the stacked table;
3. ``StackSequencer.play_packed_sharded`` -- shot fan-out: every shard
   plays its slice of a randomized shot sequence.

    python examples/torch_multichip_mesh.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveforms_tpu_torch import (WaveVStack, cosPulse,  # noqa: E402
                                 mixing, square, synthesize, zero)
from waveforms_tpu_torch.ops import StackSequencer  # noqa: E402
from waveforms_tpu_torch.ops.lowering import lower_schedule  # noqa: E402
from waveforms_tpu_torch.ops.stack_seq import (  # noqa: E402
    synthesize_stack_sharded)
from waveforms_tpu_torch.parallel.mesh import (  # noqa: E402
    channel_mesh, synthesize_on_mesh)

FS, STOP = 2e9, 8.192e-6


def main(device: str = 'cuda') -> None:
    mesh = channel_mesh(4, 2, devices=[device] * 8)
    print("mesh: (channel, time) =", tuple(mesh.devices.shape), "on",
          sorted({str(d) for d in mesh.devices.flat}))

    # -- 1) routed mesh synthesis (8 XY/Z channels) ------------------------
    rng = np.random.default_rng(0)
    chans = []
    for c in range(8):
        if c % 2 == 0:
            x = zero()
            for _ in range(3):
                I, _ = mixing(0.5 * cosPulse(20e-9) >> rng.uniform(0, 7e-6),
                              freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
                x += I
            chans.append(x)
        else:
            chans.append(0.3 * square(200e-9, edge=20e-9) >> 2e-6)
    sig = synthesize_on_mesh(chans, 0.0, STOP, FS, mesh).gather()
    one = synthesize(chans, 0.0, STOP, FS, device=device)
    print("routed mesh output:", tuple(sig.shape), sig.dtype,
          "equal to one device:", bool(torch.equal(sig.cpu(), one.cpu())))

    # int16 DAC codes with a 14-bit full scale, straight off the mesh
    codes = synthesize_on_mesh(chans, 0.0, STOP, FS, mesh,
                               out_dtype=torch.int16,
                               dac_scale=8191.0).gather()
    print("DAC codes:", tuple(codes.shape), codes.dtype,
          "max |code| =", int(codes.abs().max()))

    # -- 2) vstack-class schedules: the shards are table slices ------------
    vstacks = [WaveVStack([float(a) * cosPulse(50e-9) >> float(o)
                           for a, o in zip(rng.uniform(0.2, 1.0, 40),
                                           rng.uniform(0, STOP - 1e-7, 40))])
               for _ in range(4)]
    out = synthesize_stack_sharded(vstacks, 0.0, STOP, FS, mesh).gather()
    print("sharded stack output:", tuple(out.shape))

    # -- 3) shot fan-out: each shard plays its slice of the sequence -------
    lows = [lower_schedule([v], 0.0, STOP, FS, bucket_samples=None)
            for v in vstacks[:3]]
    seq = StackSequencer(lows, device=device)
    ks = rng.integers(0, 3, size=16)
    shots = seq.play_packed_sharded(ks, mesh).gather()
    print("shot batch:", tuple(shots.shape), "-- schedule ids:",
          [int(k) for k in ks])


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
