"""The plain reference that decides a run's ``correct``: PyTorch and NumPy,
importing nothing of the program.  From a configuration's numbers and the
inputs the benchmark hands both sides (seeds, the sampled profile, the
pulsar population) it works out every observation again: the keys
(``keys``), the random fields (``philox``), the portrait, noise scale,
dispersion shift, fold, quantizer and folded profile (``fold``,
``observations``), and the TOA fit and prior draws (``toa``)."""
