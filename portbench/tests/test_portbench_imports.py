"""A static check of what a run's process can load: every module that
``run.py`` reaches (the harness, each traffic's driver, each metric's
reader, the reference, and the program's modules they import, followed
through the repository) imports no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``plnerf`` (compared whole:
``plnerf_torch`` begins with ``plnerf``); the reference imports nothing
of the program."""
import ast
import glob
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "plnerf"}


def module_file(name: str):
    """The repository file of a dotted module name, or None."""
    base = os.path.join(ROOT, *name.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def module_name(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def imports_of(path: str):
    """Every module name ``path`` imports (at any depth of its code),
    relative imports resolved."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    pkg = module_name(path)
    if not path.endswith("__init__.py"):
        pkg = pkg.rpartition(".")[0]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def entry_files():
    return ([os.path.join(BENCH, "run.py")]
            + glob.glob(os.path.join(BENCH, "lib", "*.py"))
            + glob.glob(os.path.join(BENCH, "drivers", "*.py"))
            + glob.glob(os.path.join(BENCH, "metrics", "*.py"))
            + glob.glob(os.path.join(BENCH, "reference", "*.py")))


def reached(starts):
    """{file: [imported top-level names]} of everything reachable from
    ``starts`` through the repository's own modules."""
    seen, todo, tops = set(), list(starts), {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tops[path] = set()
        for name in imports_of(path):
            tops[path].add(name.split(".")[0])
            f = module_file(name)
            if f is not None:
                todo.append(f)
                # importing a submodule runs its packages' __init__ too
                parts = name.split(".")
                for i in range(1, len(parts)):
                    init = module_file(".".join(parts[:i]))
                    if init is not None:
                        todo.append(init)
    return tops


def test_nothing_a_run_reaches_imports_jax_or_the_jax_package():
    tops = reached(entry_files())
    assert any("plnerf_torch" in p for p in tops), "the program is followed"
    bad = {os.path.relpath(p, ROOT): sorted(t & FORBIDDEN)
           for p, t in tops.items() if t & FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    refs = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    tops = reached(refs)
    bad = {os.path.relpath(p, ROOT): sorted(t & {"plnerf_torch"} | (
        t & FORBIDDEN)) for p, t in tops.items()
        if t & ({"plnerf_torch"} | FORBIDDEN)}
    assert not bad


def test_whole_name_comparison():
    # a prefix test would wrongly match the port
    assert "plnerf_torch".split(".")[0] not in FORBIDDEN
    assert "plnerf.core".split(".")[0] in FORBIDDEN
