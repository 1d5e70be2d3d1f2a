"""Session hooks for every pytest run from the repo root.

Under ``--dist loadfile`` pytest-xdist queues the test files by item
count, largest first (``--loadscope-reorder``), and hands each file to one
worker whole.  The files in ``SPLIT_FIRST`` are split into one work unit
per item and dispatched before everything else, each with the smallest
unit left queued behind it; every other file keeps xdist's own grouping
and order, and runs at a lower CPU priority.  Other dist modes are left
alone.
"""

import os

import pytest

# tests/test_sharding.py: 2 items, each a subprocess that compiles JAX's
# sharded engine on the 8-device CPU mesh (1568-1738 s of junit for the
# file on an 8-vCPU host; the full-mesh item ~1290 s alone).  With the
# fewest items of any file, plain loadfile queues it last and runs both
# items on one worker, so the suite ends that long after the other files
# have been handed out.
SPLIT_FIRST = ("tests/test_sharding.py",)

# The listed items set the wall clock and use about one core each; the
# other files finish in under half of it.  A worker lowers its CPU
# priority by this much before its first unlisted item, so that on a full
# machine the listed subprocesses, at the workers' first priority, keep
# their cores (8 vCPUs, -n 6: the full-mesh item 1262-1367 s, against
# 1384-1419 s at one priority for all).
NICE = 10
_NICED = pytest.StashKey[bool]()


def _listed(scope):
    return scope.split("::", 1)[0] in SPLIT_FIRST


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if _listed(nodeid) else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            first = [s for s in self.workqueue if _listed(s)]
            # A worker starts an item only once it holds the next one, so a
            # listed item always has a unit queued behind it, which waits
            # the item's whole run: give it the smallest unit left.
            if not first and any(_listed(s) and not all(unit.values())
                                 for s, unit in self.assigned_work[node].items()):
                first = [next(reversed(self.workqueue))]
            for scope in reversed(first):
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return SplitFirstScheduling(config, log)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    # A worker sees dist "no"; tell it whether the controller splits.
    node.workerinput["split_first"] = node.config.getvalue("dist") == "loadfile"


def pytest_runtest_setup(item):
    config = item.config
    if (getattr(config, "workerinput", {}).get("split_first")
            and not _listed(item.nodeid) and not config.stash.get(_NICED, False)):
        os.nice(NICE)
        config.stash[_NICED] = True
