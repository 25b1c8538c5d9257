"""Artifact downloader: stdlib urllib with sha256 verification.

The port's copy of frechet_audio_distance_exported_tpu/utils/download.py
(L1-81) without the optional tqdm progress bar (the port runs where tqdm is
absent; it prints nothing instead). Mirror of the reference's
download-on-miss behavior (reference: fad.py:95-106 URL table;
fad.py:275-286 torch.hub.download_url_to_file on cache miss): chunked
urllib streaming into a temp file, optional sha256 pin, atomic rename.

Set FAD_TPU_OFFLINE=1 to forbid all network access (tests, air-gapped
deployments); downloads then raise immediately with a clear message.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.request


def offline() -> bool:
    return os.environ.get("FAD_TPU_OFFLINE", "") not in ("", "0")


def download_url_to_file(
    url: str,
    dst: str,
    sha256: str | None = None,
    chunk_size: int = 1 << 20,
    timeout: float = 30.0,
) -> str:
    """Stream ``url`` to ``dst`` atomically; verify sha256 when given."""
    if offline():
        raise RuntimeError(
            f"FAD_TPU_OFFLINE is set; refusing to download {url}. "
            f"Place the file at {dst} manually."
        )
    dst = os.path.abspath(dst)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "fad-tpu/0.1"})
    digest = hashlib.sha256()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dst), suffix=".part")
    try:
        # fdopen first: the descriptor must be owned by the file object (and
        # closed) even when urlopen raises before any byte arrives.
        with os.fdopen(fd, "wb") as f:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                while True:
                    buf = resp.read(chunk_size)
                    if not buf:
                        break
                    f.write(buf)
                    digest.update(buf)
        if sha256 is not None and digest.hexdigest() != sha256:
            raise RuntimeError(
                f"sha256 mismatch for {url}: got {digest.hexdigest()}, expected {sha256}"
            )
        shutil.move(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dst
