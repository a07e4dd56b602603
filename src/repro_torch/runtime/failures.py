"""Failure vocabulary of the runtimes.

The threads backend is the only runtime of the port so far; the failure
injection and detection of the multi-process transport arrive with it.
"""

from __future__ import annotations


class WorkFunctionError(RuntimeError):
    """The user's work function raised inside a worker; the job fails fast.

    Shared by every backend so a spec validated on the threads runtime
    (paper §6.1 single-host confidence building) fails with the same
    exception type it would on the real cluster.
    """
