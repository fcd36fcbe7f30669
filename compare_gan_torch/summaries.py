"""Training summaries on the host (counterpart of
compare_gan_tpu/summaries.py).

The JAX package writes TensorBoard event files when TensorFlow is
importable and falls back to `<model_dir>/summaries.jsonl` otherwise. The
port writes the JSONL form only, with the fallback's keys: one line
`{"step", "tag", "value", "time"}` per scalar and `{"step", "tag",
"image_shape"}` per image grid (the grid's pixels are not stored).
`tools/tb_scalars.py` reads either form.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from compare_gan_torch import utils


class SummaryWriter:
    """Scalars every call, image grids on a due-step cadence
    (`save_summary_steps`, 250 by default as in the JAX package)."""

    def __init__(self, model_dir: str, save_summary_steps: int = 250):
        self._every = save_summary_steps
        self._next_due = save_summary_steps
        os.makedirs(model_dir, exist_ok=True)
        self._jsonl = open(os.path.join(model_dir, "summaries.jsonl"), "a")

    def should_write(self, step: int) -> bool:
        """Is an image summary due at `step`? A pure predicate: the loop
        asks only at host syncs, which need not land on multiples of the
        cadence, and acts, then calls `mark_written(step)`."""
        return step >= self._next_due

    def mark_written(self, step: int) -> None:
        if step >= self._next_due:
            self._next_due = (step // self._every + 1) * self._every

    def _write(self, record: dict) -> None:
        self._jsonl.write(json.dumps(record) + "\n")

    def scalar(self, tag: str, value, step: int) -> None:
        self._write({"step": step, "tag": tag,
                     "value": float(np.asarray(value)), "time": time.time()})

    def scalars(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            self.scalar(tag, value, step)

    def image_grid(self, tag: str, images, step: int, grid_shape=(8, 8)
                   ) -> None:
        """An 8x8 grid of `images` [N, H, W, C] in [0, 1]; only the first
        gh*gw are used, and a partial grid is made square."""
        images = np.asarray(images)
        cells = grid_shape[0] * grid_shape[1]
        n = min(len(images), cells)
        grid = utils.image_grid(images[:n],
                                grid_shape=None if n < cells else grid_shape)
        self._write({"step": step, "tag": tag,
                     "image_shape": list(grid.shape)})

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
