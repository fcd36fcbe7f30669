"""AbstractGAN interface (counterpart of
compare_gan_tpu/gans/abstract_gan.py)."""

from __future__ import annotations

import abc


class AbstractGAN(abc.ABC):
    """Interface for GAN models that can be trained with the runner."""

    def __init__(self, dataset, parameters, model_dir):
        self._dataset = dataset
        self._parameters = dict(parameters or {})
        self._model_dir = model_dir

    @property
    def dataset(self):
        return self._dataset

    @property
    def model_dir(self):
        return self._model_dir

    @property
    @abc.abstractmethod
    def num_sub_steps(self) -> int:
        """Input batches per train step (disc_iters + 1)."""

    @abc.abstractmethod
    def init_state(self, seed):
        """Build and initialize the models; return the TrainState."""

    @abc.abstractmethod
    def make_train_step(self, batch_size):
        """Return `(train_state, batch, draws=None) -> (train_state,
        metrics)`."""

    @abc.abstractmethod
    def input_batches(self, batch_size, skip_batches=0):
        """Host iterator of batches sized batch_size * num_sub_steps."""
