"""Nothing the harness and the port load is JAX or the JAX package, by
whole top-level names, and the reference loads nothing of the program."""

import subprocess
import sys

import harness
from conftest import BENCH, small_cell

CHECK = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'waveforms_tpu'))
port = sorted(m for m in sys.modules
              if m.split('.')[0] == 'waveforms_tpu_torch')
print(repr((bad, port)))
"""


def run(body):
    import os
    code = CHECK.format(bench=BENCH, root=os.path.dirname(BENCH), body=body)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault('waveforms_tpu_torch_probe', sys)
    assert 'waveforms_tpu_torch_probe' not in harness.forbidden_modules()
    del sys.modules['waveforms_tpu_torch_probe']


def test_a_run_of_every_cell_loads_no_jax():
    bad, port = run("""
import conftest, harness, time
for cell in ('chip64.sweep', 'station_rb.chain', 'chip64.predistort'):
    cfg, mix, driver, limits = conftest.small_cell(cell)
    harness.run_cell(cell, cfg, mix, driver, limits, 5, 0.2, False, 'cpu',
                     time.perf_counter())
""".replace('import conftest', f'sys.path.insert(0, {BENCH + "/tests"!r}); '
            'import conftest'))
    assert bad == [] and port


def test_the_reference_loads_nothing_of_the_program():
    bad, port = run('import reference.plane, reference.chain, draws, peaks')
    assert bad == [] and port == []
