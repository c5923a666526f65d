"""The port's documentation against the port (the counterpart of
tests/test_migration_doc.py): docs/port.md and docs/torch/*.md.

* every dotted ``enoki_tpu_torch`` name in those pages resolves, and so
  does every name of docs/torch/migration.md's port column;
* every enoki-tpu name of the reference's docs/migration.md (the names of
  its enoki-tpu column that resolve in enoki_tpu, a slash list such as
  ``ops.popcnt/lzcnt`` taken name by name) resolves in enoki_tpu_torch,
  or stands in docs/port.md's table of deliberate differences with a
  counterpart that resolves;
* each fenced ``python`` snippet of docs/torch/*.md runs on the CPU
  (``device="cpu"``, small sizes), all of them in under 20 s together.
"""

import contextlib
import importlib
import io
import re
import time
from pathlib import Path

import pytest

import enoki_tpu
import enoki_tpu_torch

DOCS = Path(__file__).resolve().parents[1] / "docs"
PAGES = sorted((DOCS / "torch").glob("*.md"))
SUBMODULES = ("trace", "trace.call", "struct", "types", "render", "dist",
              "runtime", "interop", "ops.special", "ops.math",
              "ops.backend", "ad", "config")
SNIPPET_SECONDS = 20.0


def roots_of(pkg):
    """The names a migration table's entries start with, in ``pkg``."""
    for m in SUBMODULES:
        importlib.import_module(f"{pkg.__name__}.{m}")
    return {"enoki_tpu": pkg, "ops": pkg.ops, "trace": pkg.trace,
            "struct": pkg.struct, "types": pkg.types, "render": pkg.render,
            "dist": pkg.dist, "runtime": pkg.runtime, "interop": pkg.interop,
            "config": (pkg.config.config, pkg.config), "ad": pkg.ad,
            "LazyArray": pkg.trace.LazyArray, "PCG32": pkg.types.PCG32}


def resolves(roots, name):
    parts = name.split(".")
    objs = roots[parts[0]]
    for obj in objs if isinstance(objs, tuple) else (objs,):
        for p in parts[1:]:
            if not hasattr(obj, p):
                break
            obj = getattr(obj, p)
        else:
            return True
    return False


def import_path(name):
    """Whether a dotted name rooted at enoki_tpu_torch resolves: the
    longest module prefix imported, the rest taken as attributes."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:k]))
        except ImportError:
            continue
        for p in parts[k:]:
            if not hasattr(obj, p):
                return False
            obj = getattr(obj, p)
        return True
    return False


_SPAN = re.compile(r"`([^`]+)`")
_NAME = re.compile(r"([A-Za-z_]\w*(?:\.[A-Za-z_]\w*)+)((?:/[A-Za-z_]\w*)*)")


def table_names(path, column, roots):
    """The dotted names of ``column`` of every table row of ``path``
    (backticked; ``a.b/c`` gives a.b and a.c), rooted at ``roots``."""
    names = set()
    for line in path.read_text().splitlines():
        cells = line.split("|")
        if not line.strip().startswith("|") or len(cells) < 3:
            continue
        for span in _SPAN.findall(cells[column]):
            for m in _NAME.finditer(span):
                head, tail = m.group(1), m.group(2)
                if head.split(".")[0] not in roots:
                    continue
                names.add(head)
                stem = head.rsplit(".", 1)[0]
                names.update(f"{stem}.{t}" for t in tail.split("/")[1:])
    return names


REF = roots_of(enoki_tpu)
PORT = roots_of(enoki_tpu_torch)
REFERENCE_NAMES = sorted(n for n in table_names(DOCS / "migration.md", -2,
                                                REF) if resolves(REF, n))


def dotted_port_names():
    names = set()
    for path in [DOCS / "port.md", *PAGES]:
        names.update(re.findall(r"\benoki_tpu_torch(?:\.[A-Za-z_]\w*)+",
                                path.read_text()))
    return sorted(names)


@pytest.mark.parametrize("name", dotted_port_names())
def test_a_dotted_name_of_the_port_docs_resolves(name):
    assert import_path(name), f"{name} does not resolve"


def test_the_port_column_of_the_migration_page_resolves():
    names = table_names(DOCS / "torch" / "migration.md", 2, PORT)
    assert len(names) >= len(REFERENCE_NAMES)
    missing = sorted(n for n in names if not resolves(PORT, n))
    assert not missing, missing


def deliberate_differences():
    """{reference name: port names} of docs/port.md's table."""
    table = {}
    for line in (DOCS / "port.md").read_text().splitlines():
        cells = line.split("|")
        if len(cells) < 5 or not cells[1].strip().startswith("`"):
            continue
        ref = [m.group(1) for s in _SPAN.findall(cells[1])
               for m in _NAME.finditer(s)]
        port = [m.group(1) for s in _SPAN.findall(cells[2])
                for m in _NAME.finditer(s)]
        for r in ref:
            table.setdefault(r, []).extend(port)
    return table


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_a_name_of_the_reference_migration_page_is_in_the_port(name):
    if resolves(PORT, name):
        return
    counterparts = deliberate_differences().get(name, [])
    assert any(resolves(PORT, c) for c in counterparts), (
        f"docs/migration.md names `{name}`: not in enoki_tpu_torch, nor in "
        f"docs/port.md's deliberate differences")


def test_the_differences_table_names_what_the_port_has():
    table = deliberate_differences()
    assert "runtime.kernel_printf" in table and "trace.LazyArray.jax" in table
    for ref, port in table.items():
        assert port and all(resolves(PORT, p) for p in port), (ref, port)


def snippets():
    out = []
    for path in PAGES:
        for k, code in enumerate(re.findall(r"```python\n(.*?)```",
                                            path.read_text(), re.S)):
            out.append((f"{path.stem}-{k}", code))
    return out


SNIPPETS = snippets()


@pytest.fixture(scope="module")
def ran():
    """{snippet id: (error or None, seconds)}: every snippet run once, in
    a namespace of its own, its printing kept off the test's output."""
    out = {}
    for name, code in SNIPPETS:
        t0 = time.perf_counter()
        err = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                exec(compile(code, name, "exec"), {"__name__": name})
        except Exception as e:  # noqa: BLE001 - reported by the test
            err = f"{type(e).__name__}: {e}"
        out[name] = (err, time.perf_counter() - t0)
    return out


@pytest.mark.parametrize("name", [n for n, _ in SNIPPETS])
def test_a_snippet_of_the_port_docs_runs_on_the_cpu(ran, name):
    err, _ = ran[name]
    assert err is None, err


def test_every_page_has_a_snippet_and_they_run_in_time(ran):
    assert {p.stem for p in PAGES} == {n.split("-")[0] for n, _ in SNIPPETS}
    total = sum(s for _, s in ran.values())
    assert total < SNIPPET_SECONDS, total
