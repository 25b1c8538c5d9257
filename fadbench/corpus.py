"""The corpus generator: two pools of PCM16 WAV clips drawn from a seed, and
the directory pairs that the calls of one run score.

A traffic file (fadbench/traffic/<name>.json) gives every parameter:

- ``sample_rate``, ``clip_seconds``: the clips' rate and length (mono);
- ``pools``: per side (``background``, ``eval``) the pool's ``clips`` and the
  law of one clip, Gaussian noise with a power spectrum falling as
  1/f^tilt, ``tilt`` drawn uniformly in its range, scaled to an RMS level
  drawn uniformly in ``level_dbfs``; the two sides draw from different
  ranges, so the distance between them is far from zero;
- ``clips_per_call``: per side, the clips one call scores, a draw without
  replacement from that side's pool;
- ``directories``: k, the directories a run links per side for its window
  (and one more per side for the warm-up call); the window's calls score
  the k * k pairs of them, no pair twice. Pairs are combined from k
  directories a side, not linked one by one, because a link costs about
  0.2 ms on the temporary file system of the H100 hosts measured;
- ``score``, ``fad``: keyword arguments of ``score()`` and of
  ``FrechetAudioDistance()`` (such as its decode threads,
  ``audio_load_worker``), which the harness passes on.

Every clip is made on the device in blocks and quantised to int16 there;
the pools then live on the host. The same seed gives the same pools and
pairs on the same kind of device.
"""

from __future__ import annotations

import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

SIDES = ("background", "eval")
BLOCK_CLIPS = 128


def seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for the pools, the weights and the pairs."""
    words = np.random.SeedSequence(int(seed)).generate_state(3, dtype=np.uint64)
    return {k: int(w) >> 1 for k, w in zip(("pools", "weights", "directories"), words)}


def clip_samples(traffic: dict) -> int:
    return int(round(traffic["sample_rate"] * traffic["clip_seconds"]))


def make_pools(traffic: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """{side: int16 [clips, samples]} on the host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    samples = clip_samples(traffic)
    nbin = samples // 2 + 1
    # 1/f^tilt power: amplitude |f|^(-tilt/2), DC held at the first bin's.
    freq = torch.arange(nbin, device=device, dtype=torch.float32).clamp_min(1.0) / nbin
    pools = {}
    for side in SIDES:
        law = traffic["pools"][side]
        out = np.empty((law["clips"], samples), np.int16)
        for b0 in range(0, law["clips"], BLOCK_CLIPS):
            b = min(BLOCK_CLIPS, law["clips"] - b0)
            white = torch.randn((b, samples), generator=gen, device=device)
            u = torch.rand((b, 2), generator=gen, device=device)
            tilt = law["tilt"][0] + (law["tilt"][1] - law["tilt"][0]) * u[:, :1]
            level = law["level_dbfs"][0] + (law["level_dbfs"][1] - law["level_dbfs"][0]) * u[:, 1:]
            shaped = torch.fft.irfft(
                torch.fft.rfft(white) * freq[None, :] ** (-0.5 * tilt), n=samples)
            rms = shaped.square().mean(dim=1, keepdim=True).sqrt()
            wave = shaped / rms * 10.0 ** (level / 20.0)
            pcm = torch.round(wave * 32768.0).clamp(-32768, 32767).to(torch.int16)
            out[b0 : b0 + b] = pcm.cpu().numpy()
        pools[side] = out
    return pools


def wav_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    """A canonical 44-byte-header PCM16 mono WAV file of ``pcm``."""
    data = np.ascontiguousarray(pcm, dtype="<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sample_rate, 2 * sample_rate, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data))
    return b"RIFF" + struct.pack("<I", len(body) + len(data)) + body + data


def pool_dir(root: str, side: str) -> str:
    return os.path.join(root, "pool", side)


def write_pools(root: str, pools: Dict[str, np.ndarray], sample_rate: int, workers: int = 8) -> int:
    """Write every clip once as <root>/pool/<side>/<index>.wav; returns the bytes written."""

    def write(job):
        path, pcm = job
        with open(path, "wb") as f:
            f.write(wav_bytes(pcm, sample_rate))
        return 44 + 2 * pcm.size

    jobs = []
    for side, pcm in pools.items():
        os.makedirs(pool_dir(root, side), exist_ok=True)
        jobs += [(os.path.join(pool_dir(root, side), f"{i:05d}.wav"), pcm[i]) for i in range(len(pcm))]
    with ThreadPoolExecutor(workers) as ex:
        return sum(ex.map(write, jobs))


def draw_subsets(traffic: dict, seed: int) -> Dict[str, List[np.ndarray]]:
    """{side: ``directories`` + 1 sorted draws of pool indices, no two alike};
    the last of each side is the warm-up call's."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in SIDES:
        pool, clips = traffic["pools"][side]["clips"], traffic["clips_per_call"][side]
        if math.comb(pool, clips) < traffic["directories"] + 1:
            raise ValueError(f"{side}: {traffic['directories'] + 1} different draws of {clips} "
                             f"clips do not exist in a pool of {pool}")
        draws, seen = [], set()
        while len(draws) < traffic["directories"] + 1:
            idx = np.sort(rng.choice(pool, clips, replace=False))
            if idx.tobytes() not in seen:
                seen.add(idx.tobytes())
                draws.append(idx)
        out[side] = draws
    return out


def schedule(k: int) -> List[Tuple[int, int]]:
    """(background, eval) directory of each call: the warm-up's pair (k, k),
    then all k * k pairs of the window's directories, each once, in an order
    in which every call changes both directories."""
    return [(k, k)] + [(j % k, (j % k + j // k) % k) for j in range(k * k)]


def link_dir(root: str, side: str, i: int, idx: np.ndarray) -> str:
    """<root>/dirs/<side>/<i>/ of hard links (symbolic where the file system
    refuses) to the pool files ``idx``."""
    d = os.path.join(root, "dirs", side, str(i))
    os.makedirs(d)
    for k in idx:
        src = os.path.join(pool_dir(root, side), f"{k:05d}.wav")
        dst = os.path.join(d, f"{k:05d}.wav")
        try:
            os.link(src, dst)
        except OSError:
            os.symlink(src, dst)
    return d
