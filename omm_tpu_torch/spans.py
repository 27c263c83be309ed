"""Named spans of the port's host work, as torch.profiler sees them.

`span(name)` is a `torch.profiler.record_function` range while a torch
profiler runs, and one shared do-nothing context otherwise.  A
`record_function` enters torch's dispatcher whether or not a profiler
listens (about 12 µs an entry); the gate reads the flag torch sets when
a profiler starts and clears when it stops
(`torch.autograd.profiler._is_profiler_enabled`, a module global, so it
reads the same on every thread: under `profile_all_threads` the worker
threads' spans are recorded too).  With the profiler on, the spans are
the profiler's own ranges, on the clock of its device trace.  Every
span of the port goes through here.
"""
from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the host work inside it `name` in a
    running torch profiler; a no-op where none runs."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
