"""Run a JAX-package test file's cases against the port: the file's source
with its ``repro.core`` imports pointed at ``repro_torch.core``, executed
as a module of its own, its cases (and fixtures) handed to the calling
test module."""
import importlib.util
import inspect
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
IMPORT = re.compile(r"^(\s*)(from|import) repro\.core\b", re.M)


def ported_module(fname):
    """The JAX test file ``fname``, its ``repro.core`` imports pointed at
    the port."""
    with open(os.path.join(HERE, fname)) as f:
        text = IMPORT.sub(r"\1\2 repro_torch.core", f.read())
    spec = importlib.util.spec_from_loader("_port_mirror_" + fname[:-3],
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = os.path.join(HERE, fname)
    exec(compile(text, mod.__file__, "exec"), mod.__dict__)
    return mod


def _is_fixture(obj):
    return hasattr(obj, "_fixture_function_marker") \
        or hasattr(obj, "_pytestfixturefunction")


def mirror_name(fname, case):
    return f"test_mirror_{fname[5:-3]}__{case[5:]}"


def export(namespace, fname, take=None, skip=()):
    """Put the cases of ``fname`` (all, or those in ``take``, bar
    ``skip``) into ``namespace`` as ``test_mirror_<file>__<case>``, with
    the file's fixtures under their own names.  Returns the module."""
    mod = ported_module(fname)
    for name, obj in vars(mod).items():
        if _is_fixture(obj):
            assert name not in namespace, name
            namespace[name] = obj
    for name, fn in inspect.getmembers(mod, inspect.isfunction):
        if not name.startswith("test_") or fn.__module__ != mod.__name__:
            continue
        if (take is not None and name not in take) or name in skip:
            continue
        namespace[mirror_name(fname, name)] = fn
    return mod


def check_coverage(namespace, fname, mod, take=None, skip=()):
    """Every case of ``fname`` bar ``skip`` is in ``namespace``, and the
    ported module refers to the port's modules, never the JAX package's."""
    with open(os.path.join(HERE, fname)) as f:
        cases = re.findall(r"^def (test_\w+)", f.read(), re.M)
    for c in cases:
        if (take is None or c in take) and c not in skip:
            assert mirror_name(fname, c) in namespace, c
    assert take is None or set(take) <= set(cases)
    names = {getattr(v, "__module__", None) or getattr(v, "__name__", "")
             for v in vars(mod).values()
             if inspect.ismodule(v) or inspect.isclass(v)}
    assert not any(n == "repro" or n.startswith("repro.") for n in names), \
        names
    assert any(n.startswith("repro_torch.") for n in names), names
