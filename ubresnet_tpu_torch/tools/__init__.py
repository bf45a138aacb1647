"""Measurement tools of the port (counterparts of the JAX package's
tools/): ``profile_train`` (the train-step A/B matrix) and
``int8_ladder`` (PTQ and QAT accuracy on briefly trained weights). Run
each as ``python -m ubresnet_tpu_torch.tools.<name>``."""
