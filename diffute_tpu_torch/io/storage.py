"""Pluggable blob storage and image decode.

Counterpart of ``diffute_tpu/io/storage.py``.  Paths are local files,
``file://`` URLs, schemes registered with :func:`register_opener` (``oss://``
through ``io.oss.register_oss``) or, when ``fsspec`` imports, anything it
opens (``gs://``, ``s3://``, ``http(s)://``).

Images decode with Pillow, RGB by default; ``bgr=True`` gives the channel
order of the reference's ``cv2.imdecode(flags=1)``.  PNG decodes to the
same bytes as cv2.  JPEG takes the Pillow route too (not the repository's
native libjpeg-turbo decoder that the JAX package tries first): Pillow's
decoder is libjpeg-turbo as well, and the tests hold its pixels to the JAX
package's decode within the tolerance they state.  As in that package's
native route, no EXIF orientation is applied.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Callable, Dict

import numpy as np

_OPENERS: Dict[str, Callable[[str], BinaryIO]] = {}


def register_opener(scheme: str, opener: Callable[[str], BinaryIO]) -> None:
    _OPENERS[scheme] = opener


def open_blob(path: str) -> BinaryIO:
    if "://" in path:
        scheme = path.split("://", 1)[0]
        if scheme == "file":
            return open(path.split("://", 1)[1], "rb")
        if scheme in _OPENERS:
            return _OPENERS[scheme](path)
        try:
            import fsspec
        except ImportError:
            raise ValueError(f"No opener registered for scheme {scheme!r}")
        return fsspec.open(path, "rb").open()
    return open(path, "rb")


def decode_image(data: bytes, bgr: bool = False) -> np.ndarray:
    """Decode an image blob -> uint8 (H, W, 3), RGB (BGR with ``bgr``)."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as img:
            img = np.asarray(img.convert("RGB"))
    except (UnidentifiedImageError, OSError, SyntaxError) as e:
        raise ValueError(f"Failed to decode image blob ({e})") from None
    return np.ascontiguousarray(img[..., ::-1]) if bgr else img


def read_image(path: str, bgr: bool = False) -> np.ndarray:
    """:func:`decode_image` over :func:`open_blob`."""
    with open_blob(path) as f:
        data = f.read()
    try:
        return decode_image(data, bgr=bgr)
    except ValueError as e:
        raise ValueError(f"{e}: {path}") from None
