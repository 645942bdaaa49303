"""The file order that the repo's root conftest.py gives xdist's
`--dist loadfile` queue: the long files first, then the rest by
descending test count."""

import importlib.util
import os
from types import SimpleNamespace

_HERE = os.path.dirname(os.path.abspath(__file__))

# Loaded by path: pytest keeps only one module named `conftest`.
_spec = importlib.util.spec_from_file_location(
    "root_conftest", os.path.join(os.path.dirname(_HERE), "conftest.py"))
_root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_root_conftest)
LONG_FILES = _root_conftest.LONG_FILES
order_by_file = _root_conftest.order_by_file
pytest_configure = _root_conftest.pytest_configure


def _items(spec):
    """Fake collected items: `spec` is [(file, n_tests), ...] in
    collection order."""
    return [
        SimpleNamespace(nodeid=f"tests/{name}::test_{i}")
        for name, n in spec
        for i in range(n)
    ]


def _files(items):
    seen = []
    for item in items:
        name = item.nodeid.split("::")[0].split("/")[-1]
        if name not in seen:
            seen.append(name)
    return seen


def test_long_files_first_then_by_descending_count():
    spec = [
        ("test_a.py", 3),
        (LONG_FILES[-1], 1),
        ("test_b.py", 7),
        ("test_c.py", 3),
        *[(name, 2) for name in reversed(LONG_FILES[:-1])],
        ("test_d.py", 12),
    ]
    got = _files(order_by_file(_items(spec)))
    # Equal counts keep collection order, as xdist's own sort does.
    assert got == [*LONG_FILES, "test_d.py", "test_b.py", "test_a.py",
                   "test_c.py"]


def test_order_within_a_file_is_kept():
    items = _items([("test_a.py", 2), (LONG_FILES[0], 4), ("test_b.py", 5)])
    got = order_by_file(items)
    assert sorted(got, key=id) == sorted(items, key=id)
    for name in ("test_a.py", LONG_FILES[0], "test_b.py"):
        ids = [it.nodeid for it in items if f"/{name}::" in it.nodeid]
        assert [it.nodeid for it in got if f"/{name}::" in it.nodeid] == ids


def test_long_files_exist():
    for name in LONG_FILES:
        assert os.path.isfile(os.path.join(_HERE, name)), name


def test_configure_turns_off_xdist_reorder_only_under_xdist():
    for loaded in (True, False):
        plugins = {"xdist"} if loaded else set()
        config = SimpleNamespace(
            pluginmanager=SimpleNamespace(hasplugin=plugins.__contains__),
            option=SimpleNamespace(loadscopereorder=True),
        )
        pytest_configure(config)
        assert config.option.loadscopereorder is (not loaded)
