"""Error taxonomy: the error-code enum carried through the batched
decode, plus the host-side exception classes it renders into.

Inside the batched decode exceptions are impossible, so the decode is
the source of truth: each image carries an ``ErrCode`` (plus auxiliary
payload), and the host maps codes to exception objects via the registry
below. The class names, default messages, and ``get_message`` rendering
are behavior contracts — they feed golden CLI lines like
``UNKNOWN Dials not found (match val = 17495704.0)`` byte-for-byte
(reference hierarchy: meterelf/exceptions.py:4-52) — but the mapping
machinery is this framework's own.

Copy of meterelf_tpu/errors.py: the port cannot import the JAX package (its
``__init__`` imports jax), so it carries this numpy-only copy;
tests/test_torch_params.py holds the two equal.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Optional, Type


class ErrCode(enum.IntEnum):
    """Per-image status carried through the batched decode graph.

    Priority mirrors the reference's raise order (_reading.py): a template
    match below threshold short-circuits everything (DIALS_NOT_FOUND); a
    dial whose masked image is empty raises at the FIRST such dial in
    params order (NEEDLE_CONTOURS); only after all dials are processed is
    DIAL_ANGLE raised listing unreadable dials (_reading.py:98-106).
    """

    OK = 0
    LOAD = 1              # host-side decode failure (ImageLoadingError)
    DIALS_NOT_FOUND = 2   # match max_val < threshold
    NEEDLE_CONTOURS = 3   # first dial with an empty masked needle image
    DIAL_ANGLE = 4        # >=1 dial with no usable tip pixels


_REGISTRY: Dict[ErrCode, Type["ImageProcessingError"]] = {}


class ImageProcessingError(Exception):
    """Base of the host-side error hierarchy.

    Subclasses set ``default_message`` (golden-pinned text) and,
    for graph-producible errors, ``code`` — which auto-registers the
    class as the renderer for that ErrCode.
    """

    default_message: str = "Unable to process image"
    code: Optional[ErrCode] = None

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        if cls.__dict__.get("code") is not None:
            _REGISTRY[cls.code] = cls  # type: ignore[index]

    def __init__(
        self,
        filename: str = "",
        message: Optional[str] = None,
        extra_info: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.filename = filename
        self.message = message or self.default_message
        self.extra_info = extra_info
        super().__init__()

    def __str__(self) -> str:
        return self.get_message(with_filename=True, with_extra_info=True)

    def get_message(
        self,
        *,
        with_filename: bool = False,
        with_extra_info: bool = True,
    ) -> str:
        """Render the golden-contract message:
        ``<message>[ from file: <filename>][ (<k> = <v>, ...)]``."""
        parts = [self.message]
        if with_filename and self.filename:
            parts.append(f" from file: {self.filename}")
        if with_extra_info and self.extra_info:
            pairs = ", ".join(
                f"{k} = {v}" for (k, v) in self.extra_info.items())
            parts.append(f" ({pairs})")
        return "".join(parts)


class ImageLoadingError(ImageProcessingError, IOError):
    default_message = "Unable to load image"
    code = ErrCode.LOAD


class ImageAnalyzingError(ImageProcessingError, ValueError):
    default_message = "Failed to analyze image"


class DialsNotFoundError(ImageAnalyzingError):
    default_message = "Dials not found"
    code = ErrCode.DIALS_NOT_FOUND


class DialAngleDeterminingError(ImageAnalyzingError):
    default_message = "Cannot determine angle of a dial"
    code = ErrCode.DIAL_ANGLE


class NeedleContoursNotFoundError(ImageAnalyzingError):
    default_message = "Cannot find needle contours of a dial"
    code = ErrCode.NEEDLE_CONTOURS


def error_class_for(code: int) -> Type[ImageProcessingError]:
    """The exception class registered for a graph error code."""
    return _REGISTRY[ErrCode(code)]
