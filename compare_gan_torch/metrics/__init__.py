"""Evaluation metrics of the port, the ten eval tasks of the JAX package:
FID, IS, KID, PRD, MS-SSIM and the fractal dimension over samples and the
features of the Inception network (`inception_net`); the Jacobian's
conditioning, D's accuracy and GILBO, which need the generator or the
discriminator."""
