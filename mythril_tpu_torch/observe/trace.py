"""A null tracer with the call surface of mythril_tpu/observe/trace.py.

`span` returns one shared context manager that does nothing and `instant`
records nothing, so call sites copied from the JAX package (the breaker
and quarantine events of support/resilience.py) keep their calls. The
port's own registry replaces this module (ROADMAP A 14)."""

from __future__ import annotations


class _NullSpan:
    """The do-nothing span every `span()` call returns."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs) -> _NullSpan:
    return _NULL_SPAN


def instant(name: str, **attrs) -> None:
    """A point event: nothing is recorded."""
