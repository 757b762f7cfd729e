"""Stat-tree helpers of the reducer layer.

Port of ``merge_stat_trees`` (``src/repro/core/reducers.py:75``); the
reducer protocol itself comes with the sharded and streaming lanes.
"""
from __future__ import annotations


def merge_stat_trees(model_stats, key):
    """Extract the ``stats[key]`` sub-tree from the nested per-module stats."""

    def rec(node):
        if isinstance(node, dict):
            # module-level stats dict keyed by extension name
            return node.get(key, ())
        if isinstance(node, (tuple, list)):
            return tuple(rec(c) for c in node)
        return ()

    return rec(model_stats)
