"""The convergence-proof tools of the port (counterparts of tools/*.py of
the JAX package), each run as `python -m compare_gan_torch.tools.<name>`
with the JAX tool's flags:

* `tb_scalars`: scalar summaries of a model_dir to CSV;
* `fid_anchors`: real-vs-real and real-vs-noise FID of a polygon set;
* `rotation_probe`: is the rot90 pretext learnable on a dataset;
* `eval_ema_vs_raw`: FID per checkpoint with the EMA and with the raw G;
* `s3gan_predictor_eval`: held-out accuracy of S3GAN's label predictor;
* `validate_real_assets`: the first-contact checks of a real Inception
  graph and real TFDS shards.

The tools that run a network take --device (default cuda), as
`compare_gan_torch.main` does. None imports TensorFlow; where TensorFlow
is importable, `validate_real_assets` uses it as a second oracle.
"""
