"""Run a JAX-package test file's cases against the port: the file's source
with its imports of the port's verbatim copies (``repro.core`` and the
serve-control modules ``repro.runtime.{admission,serve_fleet,
serve_loop}``) pointed at ``repro_torch``, executed as a module of its
own, its cases (and fixtures) handed to the calling test module."""
import importlib.util
import inspect
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
IMPORT = re.compile(r"^(\s*)(from|import) repro\.((?:core|runtime\."
                    r"(?:admission|serve_fleet|serve_loop))\b)", re.M)


def rewrite(text):
    """``text`` with the imports ``IMPORT`` matches pointed at the port."""
    return IMPORT.sub(r"\1\2 repro_torch.\3", text)


def _case_bodies(text):
    """Each top-level ``def test_*`` of ``text`` and its source."""
    return dict(re.findall(r"^def (test_\w+)(.*?)(?=^\S|\Z)", text,
                           re.M | re.S))


def ported_module(fname):
    """The JAX test file ``fname``, its imports of the copies pointed at
    the port."""
    with open(os.path.join(HERE, fname)) as f:
        text = rewrite(f.read())
    spec = importlib.util.spec_from_loader("_port_mirror_" + fname[:-3],
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = os.path.join(HERE, fname)
    mod._ported_source = text
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
    ported module refers to the port's modules, never the JAX package's:
    neither its module-level imports nor the imports inside the cases
    taken (where a file imports only inside its cases)."""
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
    bodies = _case_bodies(mod._ported_source)
    taken = [bodies[c] for c in cases
             if (take is None or c in take) and c not in skip]
    inner = re.findall(r"^\s*(?:from|import) (repro\S*)", "".join(taken),
                       re.M)
    assert not any(n == "repro" or n.startswith("repro.") for n in inner), \
        inner
    assert any(n.startswith("repro_torch.") for n in names) \
        or any(n.startswith("repro_torch.") for n in inner), (names, inner)
