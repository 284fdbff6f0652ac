"""The port's examples (``examples/torch_*.py``) on the CPU: each runs its
``main('cpu')`` (the kernels' plain versions) and prints its report, each
imports nothing of JAX or the JAX package, and their command line runs them
all in one process that loads no JAX.  ``chip_smoke.py``'s ``examples``
phase runs them on the card.
"""

import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    'torch_full_pipeline': ('synthesized 4 channels', 'demodulated IQ'),
    'torch_multichip_mesh': ('equal to one device: True', 'shot batch'),
    'torch_precision_tiers': ('double tier', 'max off-by'),
    'torch_precompensation': ('mid-pulse', 'droop'),
    'torch_sequence_table': ('bit-equal to play(0)', 'play_packed (stack)'),
}


def path(name):
    return os.path.join(REPO, 'examples', name + '.py')


@pytest.mark.parametrize('name', list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    spec = importlib.util.spec_from_file_location(name, path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        mod.main('cpu')
    for text in EXAMPLES[name]:
        assert text in report.getvalue(), report.getvalue()


@pytest.mark.parametrize('name', list(EXAMPLES))
def test_example_imports_no_jax(name):
    with open(path(name)) as f:
        tree = ast.parse(f.read())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    roots = {m.split('.')[0] for m in imported}
    assert not roots & {'jax', 'jaxlib', 'waveforms_tpu'}, roots
    assert 'waveforms_tpu_torch' in roots


def test_examples_command_line_loads_no_jax():
    code = (
        "import runpy, sys\n"
        f"for name in {sorted(EXAMPLES)!r}:\n"
        f"    sys.argv = [name, '--device', 'cpu']\n"
        f"    runpy.run_path({REPO!r} + '/examples/' + name + '.py',\n"
        "                   run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'waveforms_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count('\n') >= 20
