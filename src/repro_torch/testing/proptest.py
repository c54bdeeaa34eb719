"""Minimal deterministic property-testing fallback (hypothesis API subset).

Copy of ``repro/testing/proptest.py``.

The container image does not ship ``hypothesis``; the tier-1 suite only uses
``given``/``settings`` plus a handful of strategies, so this module provides
a deterministic reimplementation of exactly that subset.  Test modules prefer
the real package and fall back here::

    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:
        from repro_torch.testing.proptest import given, settings, strategies as st

Examples are generated from per-test seeds derived with crc32 (stable across
processes and runs — ``hash()`` randomization never leaks in), so failures
reproduce exactly.  There is no shrinking: the failing example's index and
arguments are attached to the raised error instead.
"""
from __future__ import annotations

import functools
import random
import zlib
from types import SimpleNamespace
from typing import Any, Callable, List

DEFAULT_MAX_EXAMPLES = 50


class Strategy:
    """A value generator: ``draw(rng) -> value``."""

    def __init__(self, draw: Callable[[random.Random], Any], label: str = ""):
        self._draw = draw
        self.label = label

    def draw(self, rng: random.Random) -> Any:
        return self._draw(rng)

    def map(self, f: Callable[[Any], Any]) -> "Strategy":
        return Strategy(lambda rng: f(self._draw(rng)), f"map({self.label})")


def integers(min_value: int, max_value: int) -> Strategy:
    return Strategy(lambda rng: rng.randint(min_value, max_value),
                    f"integers({min_value},{max_value})")


def floats(min_value: float, max_value: float) -> Strategy:
    return Strategy(lambda rng: rng.uniform(min_value, max_value),
                    f"floats({min_value},{max_value})")


def booleans() -> Strategy:
    return Strategy(lambda rng: rng.random() < 0.5, "booleans")


def sampled_from(options) -> Strategy:
    opts = list(options)
    return Strategy(lambda rng: opts[rng.randrange(len(opts))], "sampled_from")


def tuples(*elems: Strategy) -> Strategy:
    return Strategy(lambda rng: tuple(e.draw(rng) for e in elems), "tuples")


def lists(elem: Strategy, min_size: int = 0, max_size: int = 25) -> Strategy:
    def draw(rng: random.Random) -> List[Any]:
        return [elem.draw(rng)
                for _ in range(rng.randint(min_size, max_size))]
    return Strategy(draw, f"lists({elem.label})")


def randoms(use_true_random: bool = False, **_kw) -> Strategy:
    """A seeded ``random.Random`` (never true-random here: determinism)."""
    return Strategy(lambda rng: random.Random(rng.getrandbits(64)), "randoms")


strategies = SimpleNamespace(
    integers=integers, floats=floats, booleans=booleans,
    sampled_from=sampled_from, tuples=tuples, lists=lists, randoms=randoms)


def settings(max_examples: int = DEFAULT_MAX_EXAMPLES, deadline=None, **_kw):
    """Attach run parameters to a ``given``-wrapped test (deadline ignored)."""
    def deco(fn):
        fn._proptest_max_examples = max_examples
        return fn
    return deco


def given(*strats: Strategy):
    """Run the test once per generated example, deterministically seeded."""
    def deco(fn):
        base_seed = zlib.crc32(
            f"{fn.__module__}.{fn.__qualname__}".encode())

        @functools.wraps(fn)
        def runner():
            n = getattr(runner, "_proptest_max_examples",
                        DEFAULT_MAX_EXAMPLES)
            for i in range(n):
                rng = random.Random((base_seed << 20) + i)
                args = tuple(s.draw(rng) for s in strats)
                try:
                    fn(*args)
                except Exception as err:  # annotate, no shrinking
                    raise AssertionError(
                        f"property falsified on example {i}/{n} "
                        f"args={args!r}") from err

        # pytest introspects the signature through __wrapped__; drop it so
        # the original's parameters are not mistaken for fixtures.
        del runner.__wrapped__
        return runner

    return deco
