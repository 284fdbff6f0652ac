from .parser import WaveformParseError, parse_waveform_expression, wave_eval

__all__ = ['wave_eval', 'parse_waveform_expression', 'WaveformParseError']
