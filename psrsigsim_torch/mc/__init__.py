"""Monte-Carlo study engine: declarative priors -> trials on the device ->
streaming TOA/statistics reduction -> resumable, fingerprinted results
(counterpart: psrsigsim_tpu/mc/).

Declare what varies (:mod:`~psrsigsim_torch.mc.priors`), and
:class:`~psrsigsim_torch.mc.MonteCarloStudy` runs a chunk of trials at a
time on the card — pulse synthesis, ISM delays, radiometer noise (the
sampler kernel's two χ² fields), the fold, FFTFIT TOA measurement — and
reduces every chunk there into streaming accumulators.  Sweeps journal
per chunk, so a SIGKILLed 100k-trial run resumes bit-identically, and
:class:`~psrsigsim_torch.mc.StudyResult` owns the merged statistics and
the fingerprinted artifact.  ``python -m psrsigsim_torch.mc study.toml``
runs a study from a declarative spec file.  The scenario engine's
parameters are knobs too (scintillation, RFI, single-pulse energies).
``mesh=`` takes a mesh with a chan axis of 1 (trials over ``obs``),
single-process or spanning a pod (:mod:`psrsigsim_torch.runtime.dist`).
"""

from .priors import (Choice, Fixed, Grid, LogUniform, Normal, Prior,
                     Uniform, parse_prior)
from .results import StudyResult
from .study import KNOBS, MonteCarloStudy, StudyManifestError

__all__ = [
    "MonteCarloStudy",
    "StudyResult",
    "StudyManifestError",
    "KNOBS",
    "Prior",
    "Fixed",
    "Uniform",
    "LogUniform",
    "Normal",
    "Grid",
    "Choice",
    "parse_prior",
]
