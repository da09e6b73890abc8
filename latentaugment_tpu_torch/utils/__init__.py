"""Host helpers the port needs (counterpart: latentaugment_tpu/utils/),
carried so that the port loads nothing of the JAX package."""
