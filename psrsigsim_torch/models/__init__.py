"""Physical models: pulsar and telescope (counterpart:
psrsigsim_tpu/models/)."""
