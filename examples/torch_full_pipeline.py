"""End-to-end tour of the PyTorch/CUDA port: build -> synthesize ->
pre-compensate -> stream -> demodulate.

Runs on an NVIDIA GPU, where the hand-written CUDA kernels synthesize and
filter, or with ``--device cpu`` on their plain PyTorch versions.  Prints a
short report; no plotting dependencies.

    python examples/torch_full_pipeline.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
from scipy.signal import butter, tf2sos

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveforms_tpu_torch import (classify_route, cosPulse,  # noqa: E402
                                 drag_sin, mixing, square, synthesize,
                                 wave_eval, zero)
from waveforms_tpu_torch.distortion import (exp_decay_filter,  # noqa: E402
                                            predistort)
from waveforms_tpu_torch.ops import (demod_matrix,  # noqa: E402
                                     demodulate, predistort_device,
                                     synthesize_stream)
from waveforms_tpu_torch.ops.lowering import lower_schedule  # noqa: E402
from waveforms_tpu_torch.ops.synth import DeviceSchedule  # noqa: E402


def main(device: str = 'cuda') -> None:
    fs = 2e9
    start, stop = 0.0, 4e-6

    # -- 1. symbolic schedule: XY drive, flux pulse, multi-tone DRAG -------
    xy = zero()
    for k, phase in enumerate([0, np.pi / 2, np.pi]):
        I, _ = mixing(0.5 * cosPulse(20e-9) >> (0.5e-6 + k * 1e-6),
                      freq=-150e6, phase=phase, DRAGScaling=1e-10)
        xy += I
    flux = 0.3 * (square(200e-9, edge=20e-9) >> 1.2e-6)
    mt = drag_sin(0.15e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                  block_freq=(151e6, -83e6), phase=0.1) >> 2.5e-6
    dsl = wave_eval("0.2 * (gaussian(3e-08) >> 3.2e-06) * cos(2*pi*2e8)")
    channels = [xy, flux, mt, dsl]

    # -- 2. synthesis: engine='auto' picks a kernel by the device's rule ---
    low = lower_schedule(channels, start, stop, fs)
    route, _ = classify_route(low, device=device)
    out = synthesize(channels, start, stop, fs, device=device)
    host = out.cpu().numpy()
    t = np.arange(start, stop, 1 / fs)
    print(f"synthesized {host.shape[0]} channels x {host.shape[1]} samples "
          f"on {out.device} (the {route} kernel)")
    for i, ch in enumerate(channels):
        ref = np.real(ch(t))
        err = np.abs(host[i] - ref).max() / max(np.abs(ref).max(), 1e-30)
        print(f"  ch{i}: max |synth - oracle| / scale = {err:.2e}")

    # -- 3. flux-line pre-compensation on the device, against scipy -------
    inv = exp_decay_filter(0.05, 100e-9, fs, inv=True)
    pre = predistort_device(out[1].double(), [inv], device=device)
    want = predistort(host[1].astype(np.float64), [inv])
    err = np.abs(pre.cpu().numpy() - want).max() / np.abs(want).max()
    print(f"pre-compensated flux channel: peak {np.abs(want).max():.3f}, "
          f"{err:.1e} of it off scipy")

    # -- 4. streaming with the filter state carried across chunks ----------
    sos = tf2sos(*butter(3, 0.02))
    n = 0
    for chunk in synthesize_stream(DeviceSchedule(low, device),
                                   chunk_rows=16, filters=(sos, 0.0)):
        n += chunk.shape[1]
    print(f"streamed {n} filtered samples in chunks of {16 * 128}")

    # -- 5. readout demodulation (two real matrix products) ----------------
    m = demod_matrix([150e6, 200e6], host.shape[1], fs, device=device)
    iq = demodulate(out, m).cpu().numpy().astype(np.complex128)
    print("demodulated IQ magnitudes:", np.round(np.abs(iq), 4).tolist())


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
