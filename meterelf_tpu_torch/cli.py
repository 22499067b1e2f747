"""CLI entry point (behavior contract: meterelf/_main.py), the port of
meterelf_tpu/cli.py.

    python -m meterelf_tpu_torch PARAMETERS_FILE [IMAGE_FILE...]

Each image produces one line:
``<filename>: <%07.3f value | UNKNOWN <error message>>[ <debug dict>]``
byte-identical to the reference and to ``python -m meterelf_tpu``,
including the reference's quirk of printing an empty value when the
reading is exactly 0.000 (``if data.value`` treats 0.0 as falsy,
_main.py:17).

Environment knobs (the JAX package's, plus the device):

- ``METERELF_BATCH_SIZE``: decode batch size (default 64).
- ``METERELF_EXACT=0``: float32 fast mode (``MeterDecoder(exact=False)``).
- ``METERELF_DEVICE``: the torch device (default ``cuda``; ``cpu`` runs
  every kernel's plain version). Without a card the decoder raises:
  nothing falls back to the CPU unasked.
- ``DEBUG`` (any token): appends the per-dial reading dict to each line,
  re-raises errors instead of printing them, and writes annotated
  overlay PNGs into ``METERELF_DEBUG_DIR`` (default ``meterelf-debug``);
  the ``masks`` mode also writes the per-dial masks (debugviz.py).
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from . import debugging
from .api import MeterImageData, get_meter_values

USAGE = "Usage: {prog} PARAMETERS_FILE [IMAGE_FILE...]"


def format_result(data: MeterImageData, debug: bool = False) -> str:
    """Render one golden output line (contract documented above)."""
    value = f"{data.value:07.3f}" if data.value else ""  # 0.000 quirk
    error = f"UNKNOWN {data.error.get_message()}" if data.error else ""
    suffix = f" {data.meter_values!r}" if debug else ""
    return f"{data.filename}: {value}{error}{suffix}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = list(sys.argv if argv is None else argv)
    if len(args) < 2:
        raise SystemExit(USAGE.format(prog=args[0] if args else "meterelf"))
    params_file, filenames = args[1], args[2:]

    batch_size = int(os.environ.get("METERELF_BATCH_SIZE", "64"))
    exact = os.environ.get("METERELF_EXACT", "1") != "0"
    debug = bool(debugging.DEBUG)

    debug_dir = os.environ.get("METERELF_DEBUG_DIR", "meterelf-debug")
    debug_params = None
    if debug:
        from . import debugviz
        from .params import load as load_params

        debug_params = load_params(params_file)
        if "masks" in debugging.DEBUG:
            debugviz.render_masks(debug_params, debug_dir)

    for data in get_meter_values(params_file, filenames,
                                 batch_size=batch_size, exact=exact):
        print(format_result(data, debug))
        if debug_params is not None and data.error is None:
            from . import debugviz

            debugviz.render_overlay(data.filename, debug_params, debug_dir)


if __name__ == "__main__":
    main()
