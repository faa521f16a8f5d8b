"""Datasets and batch feeding of the port.

``Loader``, ``FastLoader``, ``BatchAugmenter``, the augmentations and the
synthetic datasets are the JAX package's numpy code (``pointvit_tpu.data``,
whose modules import no jax); this package adds what those cannot give
without jax: the pinned-memory :class:`Prefetcher`, and
:class:`pointvit_tpu_torch.data.scanobjectnn.ScanObjectNN`, whose offline
FPS runs on the port. Importing this package imports nothing of the JAX
package; importing ``scanobjectnn`` does (its numpy dataset class).
"""

from pointvit_tpu_torch.data.loader import Prefetcher, to_device

__all__ = ["Prefetcher", "to_device"]
