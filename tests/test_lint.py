"""Static hygiene checks.

Round-4 verdict found a latent NameError in ``parallel/dist_solve.py``:
``Any`` was used in dataclass annotations but never imported — only
``from __future__ import annotations`` kept it from detonating.  This
test forces every annotation in the package to actually resolve, so
annotation-only names can't silently regress again.
"""
import importlib
import inspect
import pkgutil
import typing

import pytest

import lssp_tpu


def _iter_modules():
    for info in pkgutil.walk_packages(lssp_tpu.__path__, "lssp_tpu."):
        yield info.name


MODULES = sorted(_iter_modules())


@pytest.mark.parametrize("modname", MODULES)
def test_annotations_resolve(modname):
    mod = importlib.import_module(modname)
    for name, obj in vars(mod).items():
        if inspect.isclass(obj) and obj.__module__ == modname:
            # Resolves stringified annotations (PEP 563) against the
            # module globals — raises NameError on any unimported name.
            typing.get_type_hints(obj, include_extras=True)
        elif inspect.isfunction(obj) and obj.__module__ == modname:
            typing.get_type_hints(obj, include_extras=True)


def test_no_backend_name_branch():
    """One execution policy for every backend: no Python file compares a
    backend name with the previous target's or imports that target's
    Pallas API.  (The pattern is assembled so that this file does not
    match it.)"""
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "t" + "pu"
    pat = re.compile(rf"pallas\.{name}|pl{name}|[\"']{name}[\"']")
    hits = []
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if not x.startswith((".", "_"))]
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p, encoding="utf-8") as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.search(line):
                            hits.append(f"{p}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)
