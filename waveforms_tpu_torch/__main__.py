"""CLI entry point: ``python -m waveforms_tpu_torch sample "cosPulse(20)" out.npy``.

The JAX package's command line (``waveforms_tpu/__main__.py``) on the port,
behavior-compatible with the reference console script
(``feihoo87/waveforms: waveforms/__main__.py:4-35``), including its quirks:
click infers INT for ``-a/-b/-l/-A`` from the integer defaults, and
``--duration`` only takes effect while ``--stop`` still has its default
value.  ``--engine`` selects the trace evaluator (``torch``, the default:
float64 on ``--device``, JAX's ``jax``/``xla``), the CUDA kernels
(``auto``, ``cuda`` and the forced ``cuda-*`` routes), the C++ host engine
(``native``) or the host oracle (``numpy``, the JAX command line's
default); ``--device`` (default ``cuda``) is where the ``torch`` and kernel
engines run, so a run with no flags synthesizes on the card and one
without a card passes ``--device cpu``.  Only this module needs
``click``.
"""

import click

_SAMPLE_OPTIONS = (
    ('--sample-rate', '-S', 44100, 'Sample rate in Hz'),
    ('--start', '-a', 0, 'Start time in seconds'),
    ('--duration', '-l', -1, 'Duration in seconds'),
    ('--stop', '-b', 1, 'Stop time in seconds'),
    ('--amplitude', '-A', 1, 'Amplitude'),
)

ENGINES = ('torch', 'numpy', 'auto', 'cuda', 'cuda-dense', 'cuda-panel',
           'cuda-sparse', 'cuda-stack', 'native')


def _resolve_window(wav, start, duration, stop, sample_rate):
    # reference quirk: duration applies only when stop is untouched (== 1)
    wav.start = start
    wav.stop = start + duration if (duration > 0 and stop == 1) else stop
    wav.sample_rate = sample_rate
    return wav


def _host(out):
    """An engine's result as an ndarray (a card tensor copied back)."""
    import numpy as np
    import torch
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def _synthesize(wav, engine, device):
    if engine == 'torch':
        from .ops import sample_waveform
        return _host(sample_waveform(wav, device=device))
    if engine != 'numpy':
        from .engine import synthesize
        return _host(synthesize([wav], wav.start, wav.stop, wav.sample_rate,
                                engine=engine, device=device))[0]
    return wav.sample()


@click.group()
def main():
    """waveforms_tpu_torch command line."""


def _sample_impl(sample_rate, start, duration, stop, amplitude, waveform,
                 output, engine, device, dtype, dac_scale):
    import numpy as np

    from . import wave_eval

    wav = _resolve_window(wave_eval(waveform), start, duration, stop,
                          sample_rate)
    if dtype == 'float64':
        # the kernel engines return f32; honor the selected dtype
        np.save(output, np.asarray(_synthesize(wav, engine, device),
                                   dtype=np.float64) * amplitude)
        return
    # narrowed outputs go through the unified engine entry (in-kernel
    # quantize on the kernel routes); the amplitude folds into the DAC
    # scale for int16 so codes round once
    from .engine import synthesize
    od = {'float32': np.float32, 'int16': np.int16}[dtype]
    out = _host(synthesize([wav], wav.start, wav.stop, wav.sample_rate,
                           engine=engine, out_dtype=od,
                           dac_scale=dac_scale * amplitude,
                           device=device))[0]
    if dtype == 'float32':
        out = out.astype(np.float32) * np.float32(amplitude)
    np.save(output, out)


def _build_sample_command():
    cmd = _sample_impl
    cmd = click.argument('output', type=click.Path(exists=False))(cmd)
    cmd = click.argument('waveform', type=str)(cmd)
    cmd = click.option('--dac-scale', default=32767.0, type=float,
                       help='Full-scale code for --dtype int16')(cmd)
    cmd = click.option('--dtype', default='float64',
                       type=click.Choice(['float64', 'float32', 'int16']),
                       help='Output dtype: float64 (reference behavior), '
                            'float32, or int16 DAC codes')(cmd)
    cmd = click.option('--device', default='cuda', type=str,
                       help="Where the torch and CUDA engines run "
                            "('cuda' or 'cpu')")(cmd)
    cmd = click.option('--engine', default='torch',
                       type=click.Choice(list(ENGINES)),
                       help='Synthesis engine: the torch trace evaluator '
                            '(float64 on --device), the CUDA kernels (auto '
                            'picks the route), the C++ host engine, or the '
                            'host oracle (numpy)')(cmd)
    for flag, short, default, helptext in reversed(_SAMPLE_OPTIONS):
        cmd = click.option(flag, short, default=default, help=helptext)(cmd)
    return main.command('sample')(cmd)


sample = _build_sample_command()


if __name__ == '__main__':
    main()
