"""File order of the test run.

Tier-1 runs `-n 6 --dist loadfile`. xdist queues files by test count
alone, so a long file of few tests starts last and runs alone to the
end. Here the long files go first: xdist hands the first six files of
its queue to six workers at once, so they start at t = 0.
"""

import collections
import os

# Longest first. A file of few tests that runs long enough to end last
# when started late belongs here.
LONG_FILES = (
    "test_sharded_inference.py",
    "test_train.py",
    "test_service.py",
)


def pytest_configure(config):
    # Keep the file order of `order_by_file`: xdist would queue files by
    # test count alone.
    if config.pluginmanager.hasplugin("xdist"):
        config.option.loadscopereorder = False


def order_by_file(items):
    """`items` grouped by file: LONG_FILES first in their order, then the
    other files by descending test count (xdist's own order). A stable
    sort, so tests keep their order within a file."""
    def file_of(item):
        return item.nodeid.split("::")[0]

    counts = collections.Counter(map(file_of, items))

    def key(item):
        name = os.path.basename(file_of(item))
        if name in LONG_FILES:
            return (LONG_FILES.index(name), 0)
        return (len(LONG_FILES), -counts[file_of(item)])

    return sorted(items, key=key)


def pytest_collection_modifyitems(config, items):
    items[:] = order_by_file(items)
