"""Shared ctypes loader for optional system codec libraries.

The port's copy of frechet_audio_distance_exported_tpu/utils/_clib.py (L1-37);
the code after this docstring is verbatim. The port never imports the JAX package.

The reference decodes every libsndfile-supported format through soundfile
(reference: fad.py:145). This build ships its own pure codecs for the
lossless formats (WAV/FLAC/AIFF/AU) and binds the system's Xiph/mpg123
libraries — present on most Linux images — for the lossy ones
(Ogg Vorbis, MP3, Ogg Opus). Everything degrades gracefully: when a
library is absent the corresponding reader raises a clear error and the
tests skip.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional


def load_library(*names: str, mode: int = ctypes.RTLD_GLOBAL) -> Optional[ctypes.CDLL]:
    """dlopen the first of ``names`` that resolves; None when none do.

    ``names`` should list explicit sonames first (``libvorbisfile.so.3``)
    and end with the bare stem (``vorbisfile``) for ``find_library``.
    """
    for name in names:
        if "." in name or "/" in name:
            try:
                return ctypes.CDLL(name, mode=mode)
            except OSError:
                continue
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path, mode=mode)
            except OSError:
                continue
    return None
