"""The port's tuple space against the reference's, on the CPU.

Random sequences of ``put``, ``try_read``, ``try_take``, ``delete``,
``count`` and ``keys`` with ``ANY``, ``FieldIn`` and ``FieldLE`` patterns
go through ``repro.core.space.TupleSpace`` and
``repro_torch.core.space.TupleSpace`` built on the same backend spec; every
result must be the same. Also: namespaces stay apart under
``ScopedSpace``, blocking calls time out with each package's
``TSTimeout``, the ledger verifies, the control-plane schemas are the
reference's field for field, a ``remote`` spec raises, and the copies that
the port keeps verbatim have the reference's code.
"""

import ast
import dataclasses
import random
import re
from pathlib import Path

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import space as ref_space
from repro.core.space import schema as ref_schema
from repro_torch.core import space as port_space
from repro_torch.core.space import schema as port_schema

SPECS = ["local", "sharded:4", "instrumented+local", "checked+local"]
SUBJECTS = ("a", "b", "c")
SRC = Path(__file__).resolve().parents[1] / "src"


def _schemas(pkg_schema):
    """Declared subjects "a" and "b" (so "c" is a violation under checked)."""
    return tuple(pkg_schema.KeySchema(
        subject=s, fields=(pkg_schema.int_field("i"), pkg_schema.int_field("j")),
        producers=frozenset(), consumers=frozenset(), deleters=frozenset(),
        lifecycle="persistent") for s in ("a", "b"))


def _space(pkg, pkg_schema, spec):
    ts = pkg.TupleSpace(backend=spec)
    checked = pkg.find_checked(ts.backend)
    if checked is not None:
        checked.registry.register_many(_schemas(pkg_schema))
    return ts


def _field(rng: random.Random, pkg, wild: bool):
    """A pattern field over 0..3: a value, or (when ``wild``) ANY, FieldIn
    or FieldLE."""
    kind = rng.randrange(4) if wild else 0
    if kind == 0:
        return rng.randrange(4)
    if kind == 1:
        return pkg.ANY
    if kind == 2:
        return pkg.FieldIn(rng.sample(range(4), rng.randrange(1, 4)))
    return pkg.FieldLE(rng.randrange(4))


def _op(seed: int, pkg):
    """(name, args) of one operation, drawn from ``seed`` so that both
    packages get the same operation with their own ANY and predicates."""
    rng = random.Random(seed)
    name = rng.choice(("put", "put", "put", "try_read", "try_take", "delete",
                       "count", "keys"))
    if name == "put":
        key = (rng.choice(SUBJECTS), rng.randrange(4), rng.randrange(4))
        return name, (key, rng.randrange(1000))
    subject = pkg.ANY if rng.random() < 0.2 else rng.choice(SUBJECTS)
    wild = rng.random() < 0.7
    return name, ((subject, _field(rng, pkg, wild), _field(rng, pkg, wild)),)


def _apply(ts, name, args):
    if name == "put":
        return ts.put(*args)
    if name == "try_take":
        return ts.try_get(*args)
    return getattr(ts, name)(*args)


@pytest.mark.parametrize("spec", SPECS)
@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 10**9), min_size=1, max_size=60))
def test_random_operations_give_the_reference_results(spec, seeds):
    ref = _space(ref_space, ref_schema, spec)
    port = _space(port_space, port_schema, spec)
    assert type(port.backend).__name__ == type(ref.backend).__name__
    for seed in seeds:
        name, ref_args = _op(seed, ref_space)
        _, port_args = _op(seed, port_space)
        assert _apply(port, name, port_args) == _apply(ref, name, ref_args), (name, ref_args)
    everything = (ref_space.ANY,) * 3
    assert port.snapshot() == ref.snapshot()
    assert sorted(port.keys((port_space.ANY,) * 3)) == sorted(ref.keys(everything))
    assert port.ledger.verify() and ref.ledger.verify()
    assert [(e.op, e.key) for e in port.ledger.entries] == \
        [(e.op, e.key) for e in ref.ledger.entries]
    ref_checked = ref_space.find_checked(ref.backend)
    if ref_checked is not None:
        want = ref_checked.protocol_report()
        got = port_space.find_checked(port.backend).protocol_report()
        assert got["violations"] == want["violations"]
        assert dict(got["leaks"]) == dict(want["leaks"])


@pytest.mark.parametrize("spec", SPECS)
def test_scoped_spaces_keep_namespaces_apart(spec):
    results = []
    for pkg, sch in ((ref_space, ref_schema), (port_space, port_schema)):
        ts = _space(pkg, sch, spec)
        one, two = pkg.as_scoped(ts, "one"), pkg.as_scoped(ts, "two")
        one.put(("a", 1, 2), "mine")
        two.put(("a", 1, 2), "theirs")
        ts.put(("a", 1, 2), "root")
        row = [one.try_read(("a", 1, 2)), two.try_read(("a", 1, 2)),
               ts.try_read(("a", 1, 2)), one.count(("a", pkg.ANY, pkg.ANY)),
               two.delete(("a", pkg.ANY, pkg.ANY)), one.keys(("a", pkg.ANY, pkg.ANY)),
               two.try_read(("a", 1, 2)), ts.count(("a", pkg.ANY, pkg.ANY))]
        results.append(row)
        assert row[:3] == [(("a", 1, 2), "mine"), (("a", 1, 2), "theirs"),
                           (("a", 1, 2), "root")]
        assert row[4] == 1 and row[6] is None and row[7] == 1
        assert ts.ledger.verify()
    assert results[0] == results[1]


@pytest.mark.parametrize("spec", SPECS)
def test_blocking_calls_time_out(spec):
    for pkg, sch in ((ref_space, ref_schema), (port_space, port_schema)):
        ts = _space(pkg, sch, spec)
        ts.put(("a", 0, 0), 1)
        for call in (lambda: ts.read(("b", pkg.ANY, pkg.ANY), timeout=0.02),
                     lambda: ts.get(("b", pkg.ANY, pkg.ANY), timeout=0.02),
                     lambda: ts.take_batch(("b", pkg.ANY, pkg.ANY), 4, timeout=0.02),
                     lambda: ts.wait_count(("a", pkg.ANY, pkg.ANY), 2, timeout=0.02)):
            with pytest.raises(pkg.TSTimeout):
                call()
        assert ts.read(("a", pkg.ANY, pkg.ANY), timeout=1.0) == (("a", 0, 0), 1)
        assert ts.wait_count(("a", pkg.ANY, pkg.ANY), 1, timeout=1.0) == 1


def test_control_schemas_match_the_reference_field_for_field():
    assert [dataclasses.asdict(s) for s in port_schema.CONTROL_SCHEMAS] == \
        [dataclasses.asdict(s) for s in ref_schema.CONTROL_SCHEMAS]
    assert port_schema.ROLES == ref_schema.ROLES
    assert port_schema.LIFECYCLES == ref_schema.LIFECYCLES


@pytest.mark.parametrize("spec", ["remote", "remote+checked+sharded:4", "remote:local",
                                  "checked+remote+local"])
def test_the_remote_spec_raises_instead_of_hosting_the_space_in_process(spec):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_space.make_backend(spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_space.TupleSpace(backend=spec)


VERBATIM = ["core/tasks.py", "core/ledger.py", "core/space/api.py", "core/space/local.py",
            "core/space/schema.py", "core/space/scoped.py", "core/space/checked.py",
            "core/space/instrumented.py", "core/space/sharded.py", "core/space/raced.py",
            "core/space/crashpoint.py", "core/conflict.py", "core/costmodel.py",
            "core/gss.py", "core/executor.py", "core/manager.py", "core/faults.py",
            "data/pipeline.py"]


def _code(path: Path, rename: bool) -> str:
    """The module's AST without docstrings, module names renamed to the
    port's, and release-history tags (two capitals and a number) dropped
    from strings."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
        if rename and isinstance(node, ast.ImportFrom) and node.module:
            node.module = re.sub(r"^repro\.", "repro_torch.", node.module)
        if rename and isinstance(node, ast.Constant) and isinstance(node.value, str):
            node.value = re.sub(r"\b[A-Z]{2} \d+ ", "", node.value)
    return ast.dump(tree)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_have_the_reference_code(rel):
    assert _code(SRC / "repro_torch" / rel, False) == _code(SRC / "repro" / rel, True)
