"""The drawn table as the program takes it: waveforms built through the
port's public constructors (``cosPulse``, ``mixing``, ``square``), lowered
with ``lower_schedule`` and stacked into one ``Sequencer`` on the device.
The port's filters come from its own ``exp_decay_filter``; the reference
works them out again from the configuration's numbers."""

from __future__ import annotations

from draws import Line, draw_table


def _gate(line: Line, i: int, amp: float, phase: float):
    """One gate of a stacked line, made at its centre (time 0)."""
    from waveforms_tpu_torch import cosPulse, mixing, square

    s = line.spec
    if line.kind == 'xy':
        return mixing(amp * cosPulse(s['width_s']),
                      freq=float(line.freqs[i]), phase=phase,
                      DRAGScaling=s['drag_scaling'])[0]
    return amp * square(s['width_s'], edge=s['edge_s'])


def _pulse(line: Line, i: int, amp: float, phase: float, t: float):
    """One pulse of a summed line: shifted before it is mixed, so that an
    XY pulse's carrier phase counts from time 0."""
    from waveforms_tpu_torch import cosPulse, mixing, square

    s = line.spec
    if line.kind == 'xy':
        return mixing(amp * cosPulse(s['width_s']) >> t,
                      freq=float(line.freqs[i]), phase=phase,
                      DRAGScaling=s['drag_scaling'])[0]
    return amp * (square(s['width_s'], edge=s['edge_s']) >> t)


def channels_of_point(lines: dict[str, Line], p: int, n_channels: int,
                      gates: dict | None = None):
    """Point ``p`` of the table as a list of the port's waveforms, one a
    channel: a sum of its pulses, or for a stacked line a ``WaveVStack`` of
    its gates, each distinct gate made once (``gates``, shared between
    points) and shifted into place."""
    from waveforms_tpu_torch import WaveVStack, zero

    chans = [zero() for _ in range(n_channels)]
    gates = {} if gates is None else gates
    for line in lines.values():
        for i, c in enumerate(line.channels):
            amps = line.amps[p, i].tolist()
            times = line.times[p, i].tolist()
            phases = (line.phases[p, i].tolist() if line.phases is not None
                      else [0.0] * len(times))
            if line.stacked:
                members = []
                for a, ph, t in zip(amps, phases, times):
                    key = (line.kind, i, a, ph)
                    if key not in gates:
                        gates[key] = _gate(line, i, a, ph)
                    members.append(gates[key] >> t)
                chans[c] = WaveVStack(members)
                continue
            w = zero()
            for a, ph, t in zip(amps, phases, times):
                w += _pulse(line, i, a, ph, t)
            chans[c] = w
    return chans


def sequencer(cfg: dict, seed: int, device):
    """The configuration's table for ``seed`` on ``device`` ->
    (Sequencer, the drawn lines)."""
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule

    lines = draw_table(cfg, seed)
    gates: dict = {}
    lows = [lower_schedule(channels_of_point(lines, p, cfg['n_channels'],
                                             gates),
                           0.0, cfg['duration_s'], cfg['sample_rate_hz'])
            for p in range(cfg['points'])]
    return Sequencer(lows, device=device), lines


def z_settle_filters(cfg: dict):
    """The configuration's Z-settle pre-compensation as the port builds it:
    one ``exp_decay_filter(..., inv=True)`` (b, a) pair an exponential."""
    from waveforms_tpu_torch.distortion import exp_decay_filter

    zs = cfg['z_settle']
    return [exp_decay_filter(a, t, cfg['sample_rate_hz'], inv=True)
            for a, t in zip(zs['amps'], zs['taus_s'])]

