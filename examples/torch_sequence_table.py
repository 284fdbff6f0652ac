"""Randomized-benchmarking-style shot loop on a device-resident table,
with the PyTorch/CUDA port.

Builds K gate-sequence schedules, uploads them once as a ``Sequencer``
table, then runs a randomized shot order through synthesis and
demodulation; plays the same table through the worklist kernel, a batch
of shots, and one packed launch; then a table of narrow pulses on the
stacked-table kernel (``StackSequencer``).

    python examples/torch_sequence_table.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveforms_tpu_torch import (WaveVStack, cosPulse, mixing,  # noqa: E402
                                 zero)
from waveforms_tpu_torch.ops import Sequencer, StackSequencer  # noqa: E402
from waveforms_tpu_torch.ops.lowering import lower_schedule  # noqa: E402
from waveforms_tpu_torch.parallel import run_sequence  # noqa: E402


def main(device: str = 'cuda') -> None:
    fs, span = 2e9, 2e-6
    rng = np.random.default_rng(0)

    # -- K random Clifford-train schedules (one XY channel each) ----------
    def gate_train(n_gates: int) -> list:
        ch = zero()
        for g in range(n_gates):
            I, _ = mixing(0.5 * cosPulse(20e-9) >> (0.2e-6 + g * 0.1e-6),
                          freq=-150e6, phase=rng.uniform(0, 2 * np.pi),
                          DRAGScaling=1e-10)
            ch += I
        return [ch]

    K = 6
    lows = [lower_schedule(gate_train(int(rng.integers(2, 12))), 0, span, fs)
            for _ in range(K)]
    seq = Sequencer(lows, device=device)
    print("table:", seq.describe())

    # -- randomized shot order, demodulated at the drive IF ----------------
    shots = rng.integers(0, K, size=32)
    iq = run_sequence(seq, shots, demod_freqs=[150e6]).cpu().numpy()
    print(f"ran {len(shots)} shots -> IQ {iq.shape} {iq.dtype}")
    mags = np.abs(iq[:, 0, 0])
    for k in range(K):
        sel = mags[shots == k]
        if sel.size and not np.allclose(sel, sel[0], rtol=1e-5):
            raise RuntimeError("the shot order leaks into the IQ points")
    print("per-schedule IQ consistent across the randomized order")
    print("example |IQ| per shot:", np.round(mags[:8].astype(float),
                                              4).tolist())

    # -- the same table on the worklist kernel: gate trains are pulse-
    # sparse, so it computes the live subtiles only ------------------------
    dense0 = seq.play(0)
    if not torch.equal(seq.play_sparse(0), dense0):
        raise RuntimeError("play_sparse must equal play bit for bit")
    print("play_sparse(0) bit-equal to play(0)")

    # -- a batch of shots, and the batch as ONE panel-kernel launch --------
    batch = seq.play_many(shots[:8])
    if not torch.equal(batch[0], seq.play(int(shots[0]))):
        raise RuntimeError("play_many must equal play shot by shot")
    print(f"play_many: {batch.shape[0]} shots -> {tuple(batch.shape)}")
    packed = seq.play_packed(shots[:8])
    off = float((packed - batch).abs().max() / batch.abs().max())
    print(f"play_packed: {packed.shape[0]} shots in one kernel launch, "
          f"{off:.1e} of the peak off play_many")
    if off > 1e-6:
        raise RuntimeError("play_packed must match play_many")

    # -- stacked-table playback: a table of NARROW pulses (bare gate trains,
    # no carrier) runs the pulse-instance stack kernel, shots selecting
    # slices of the device-resident table ----------------------------------
    def bare_train(n_gates: int) -> list:
        offs = 0.2e-6 + np.arange(n_gates) * 0.1e-6
        return [WaveVStack([0.5 * cosPulse(20e-9) >> float(o)
                            for o in offs])]

    lows2 = [lower_schedule(bare_train(int(rng.integers(2, 12))),
                            0, span, fs) for _ in range(K)]
    sseq = StackSequencer(lows2, device=device)
    print("stack table:", sseq.describe())
    sout = sseq.play_packed(shots[:8])
    if not torch.allclose(sout[0], sseq.play(int(shots[0]))):
        raise RuntimeError("stacked playback must match play")
    codes = sseq.play_packed(shots[:8], out_dtype=torch.int16)
    print(f"play_packed (stack): {sout.shape[0]} shots in one launch; "
          f"int16 codes {tuple(codes.shape)} {codes.dtype}")


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
