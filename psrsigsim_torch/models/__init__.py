"""Physical models: pulsar, ISM and telescope (counterpart:
psrsigsim_tpu/models/)."""
