"""Device-mesh construction for multi-device / multi-host processing.

The framework's parallel axes (SURVEY §2):

- ``dp``   — data parallel over utterances (across devices and hosts);
- ``fb``   — frequency-bin model parallel (across devices): every
  per-bin recursion in this codebase is embarrassingly parallel over bins;
  only broadband reductions (SRP angle power, frame-mean SPP gates, AEC
  transfer-logic energies) and the MCRA 3-tap frequency smoothing (a 1-bin
  halo) cross bins, and XLA inserts the psum / collective-permute for them
  from the sharding annotations.

The frame axis is recursive (IIR) and is never sharded — it is the
``lax.scan`` axis.  The cards of one host are joined all to all (NVLink),
so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_dp: Optional[int] = None, n_fb: Optional[int] = None, devices=None) -> Mesh:
    """Build a ('dp', 'fb') mesh over the available devices.

    With no arguments: all devices go to ``fb`` (bin sharding); pass
    ``n_dp`` to split utterance data-parallelism off the front.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_dp is None and n_fb is None:
        n_dp, n_fb = 1, n
    elif n_dp is None:
        n_dp = n // n_fb
    elif n_fb is None:
        n_fb = n // n_dp
    if n_dp * n_fb != n:
        raise ValueError(f"mesh {n_dp}x{n_fb} != {n} devices")
    dev_array = np.asarray(devices).reshape(n_dp, n_fb)
    return Mesh(dev_array, axis_names=("dp", "fb"))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for a time-domain batch [B, ..., S]: utterances over ``dp``."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))
