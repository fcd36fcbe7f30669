"""Evaluation metrics of the port: FID and the Inception Score over the
features of the Inception network (`inception_net`)."""
