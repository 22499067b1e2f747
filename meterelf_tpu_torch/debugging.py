"""DEBUG-mode flag parsing.

Behavior contract (reference: meterelf/_debug.py): the ``DEBUG``
environment variable holds comma- or whitespace-separated mode tokens;
tokens spelling a falsy word (``0 no off false``, any case) are
dropped, and the token ``all`` selects every known mode. A non-empty
set turns on debug behavior: the CLI appends the per-dial reading dict
to each output line, errors are re-raised instead of printed, and the
``masks`` mode makes debugviz render per-dial mask overlays.

Copy of meterelf_tpu/debugging.py (the port cannot import the JAX
package).
"""
from __future__ import annotations

import os
from typing import AbstractSet, FrozenSet

_FALSY_WORDS = frozenset({"0", "no", "off", "false"})
ALL_MODES: FrozenSet[str] = frozenset({"masks"})


def parse_debug_modes(raw: str) -> AbstractSet[str]:
    tokens = raw.replace(",", " ").split()
    modes = {t for t in tokens if t.lower() not in _FALSY_WORDS}
    return set(ALL_MODES) if "all" in modes else modes


DEBUG = parse_debug_modes(os.getenv("DEBUG", ""))
