"""Image replay buffer for discriminator updates.

A copy of healthivert_tpu/utils/image_pool.py (parity with the reference's
util/image_pool.py:5-54): with probability 0.5 a query image is swapped
with a random buffered one, drawn from np.random.default_rng(seed), so the
pool gives the JAX package's batches for the same seed and queries.
Disabled for pix2pix (pool_size=0), kept for model variants (e.g.
CycleGAN-style training). Host-side numpy state; images pass through as
numpy arrays.
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: (B, ...) batch. Returns a batch mixing history and input."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.random() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                tmp = self.images[idx].copy()
                self.images[idx] = image.copy()
                out.append(tmp)
            else:
                out.append(image)
        return np.stack(out)
