"""Package metadata (counterpart of the reference's setup.py)."""

from setuptools import find_packages, setup

setup(
    name="compare_gan_tpu",
    version="1.0.0",
    description=("TPU-native (JAX/XLA) rebuild of compare_gan: "
                 "gin-configurable GAN training and evaluation."),
    packages=find_packages(exclude=["tests"]),
    package_data={"compare_gan_tpu.native": ["dataio.cc"],
                  "compare_gan_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "absl-py",
        "Pillow",
        "scikit-learn",
    ],
    extras_require={
        "host-tf": ["tensorflow"],  # TFRecord Example parsing, TB summaries.
    },
)
