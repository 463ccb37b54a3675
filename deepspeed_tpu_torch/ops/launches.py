"""Launch counts of the kernel wrappers.

A wrapper calls :func:`count` where it launches its kernel: its
``.launches`` goes up by one, ``.variant_launches`` by variant, and
``.variant`` names the last one. On a thread that is capturing a CUDA
graph (inside :func:`tally`) the launch is recorded in the capture's tally
instead, since it runs at each replay, not now
(``inference/graphs.py`` ``CapturedLoop`` adds the tally at every
replay). The tally is per thread, so a capture on one serving thread never
takes in another thread's launches.
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def count(wrapper, variant: str) -> None:
    """One launch of ``wrapper``'s kernel, taken by ``variant``."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally.append((wrapper, variant))
        return
    wrapper.launches += 1
    wrapper.variant = variant
    wrapper.variant_launches[variant] = (
        wrapper.variant_launches.get(variant, 0) + 1)


@contextlib.contextmanager
def tally():
    """Record this thread's launches in the yielded list of (wrapper,
    variant) instead of the wrappers' counts."""
    _local.tally = recorded = []
    try:
        yield recorded
    finally:
        _local.tally = None


def add(per_replay: dict) -> None:
    """Count one replay of a graph whose capture recorded ``per_replay``
    ({(wrapper, variant): launches})."""
    for (wrapper, variant), n in per_replay.items():
        wrapper.launches += n
        wrapper.variant = variant
        wrapper.variant_launches[variant] = (
            wrapper.variant_launches.get(variant, 0) + n)
