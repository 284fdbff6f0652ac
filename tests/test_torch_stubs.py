"""Type-stub coverage of the port's scripting surface.

The port ships a stub beside each module whose counterpart in the JAX
package carries one -- core, engine, ir/algebra, ir/registry,
ops/lowering, ops/sequencer, ops/stack_seq, parallel/mesh -- and
``py.typed``.  As ``tests/test_stubs.py`` does for the JAX package, every
public name and every public method a stub declares is checked against the
runtime module (a stale stub fails).
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / 'waveforms_tpu_torch'

PAIRS = [
    ('core.pyi', 'waveforms_tpu_torch.core'),
    ('engine.pyi', 'waveforms_tpu_torch.engine'),
    ('ir/algebra.pyi', 'waveforms_tpu_torch.ir.algebra'),
    ('ir/registry.pyi', 'waveforms_tpu_torch.ir.registry'),
    ('ops/lowering.pyi', 'waveforms_tpu_torch.ops.lowering'),
    ('ops/sequencer.pyi', 'waveforms_tpu_torch.ops.sequencer'),
    ('ops/stack_seq.pyi', 'waveforms_tpu_torch.ops.stack_seq'),
    ('parallel/mesh.pyi', 'waveforms_tpu_torch.parallel.mesh'),
]

# stub-only type aliases (no runtime counterpart by design)
ALIAS_OK = {'Factor', 'Term', 'Expr', 'Bounds', 'Seq', 'FunctionLib',
            'Engine', 'RouteKind', 'Device', 'Index'}


def _declared(tree):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            yield node.target.id
        elif isinstance(node, ast.Assign):
            yield from (t.id for t in node.targets if isinstance(t, ast.Name))


@pytest.mark.parametrize('stub,modname', PAIRS)
def test_stub_names_exist_at_runtime(stub, modname):
    tree = ast.parse((PKG / stub).read_text())
    mod = importlib.import_module(modname)
    missing = [n for n in _declared(tree)
               if not n.startswith('_') and n not in ALIAS_OK
               and not hasattr(mod, n)]
    assert not missing, f"{stub} declares names absent at runtime: {missing}"


@pytest.mark.parametrize('stub,modname', PAIRS)
def test_stub_methods_exist_at_runtime(stub, modname):
    tree = ast.parse((PKG / stub).read_text())
    mod = importlib.import_module(modname)
    for node in tree.body:
        if not isinstance(node, ast.ClassDef) or node.name.startswith('_'):
            continue
        assert hasattr(mod, node.name), f"{stub}: {node.name} missing"
        cls = getattr(mod, node.name)
        for sub in node.body:
            if (isinstance(sub, ast.FunctionDef)
                    and not sub.name.startswith('_')):
                assert hasattr(cls, sub.name), (
                    f"{stub}: {node.name}.{sub.name} missing")


def test_every_stub_of_the_jax_package_has_its_port_counterpart():
    jax_stubs = {p.relative_to(ROOT / 'waveforms_tpu').as_posix()
                 for p in (ROOT / 'waveforms_tpu').rglob('*.pyi')}
    assert jax_stubs == {s for s, _ in PAIRS}
    assert (PKG / 'py.typed').exists()


def test_engine_stub_names_the_engines():
    """The stub's Engine literal is the runtime's ENGINES, 'torch' among
    them."""
    from waveforms_tpu_torch.engine import ENGINES
    tree = ast.parse((PKG / 'engine.pyi').read_text())
    lit = next(n for n in tree.body if isinstance(n, ast.Assign)
               and n.targets[0].id == 'Engine')
    names = [e.value for e in lit.value.slice.elts]
    assert sorted(names) == sorted(ENGINES) and 'torch' in names
