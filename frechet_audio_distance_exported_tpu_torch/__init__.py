"""Fréchet Audio Distance on PyTorch and CUDA (Hopper).

The port of frechet_audio_distance_exported_tpu, which stays the reference.
It imports torch, numpy and scipy, never jax.
"""

from .fad import FrechetAudioDistance

__all__ = ["FrechetAudioDistance"]
