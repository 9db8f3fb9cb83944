"""The program's objects for a configuration file: what the benchmark hands
the system under test.  Everything here goes through the program's public
surface, as a user builds it."""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def profile_data(config):
    """The configuration's sampled pulse profile (a raw file that the
    program and the reference both read)."""
    return np.load(ROOT / config["profile_file"])


def telescope(config, name="BenchScope", system="BenchSys"):
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope

    t = config["telescope"]
    tel = Telescope(t["aperture_m"], area=t["area_m2"], Tsys=t["tsys_k"],
                    name=name)
    tel.add_system(system, Receiver(fcent=config["fcent_mhz"],
                                    bandwidth=config["bw_mhz"], name="Rcvr"),
                   Backend(samprate=t["backend_samprate_mhz"], name="Back"))
    return tel


def fold_signal(config, sublen_s=None, tobs_s=None, dm=None):
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.utils import make_quant

    # a fold-mode signal samples below the band's Nyquist rate; the
    # program says so on stdout, which is the result's channel
    with contextlib.redirect_stdout(io.StringIO()):
        sig = FilterBankSignal(config["fcent_mhz"], config["bw_mhz"],
                               Nsubband=config["nchan"],
                               sample_rate=config["sample_rate_mhz"],
                               fold=True,
                               sublen=sublen_s or config["sublen_s"])
    sig._tobs = make_quant(tobs_s or config["tobs_s"], "s")
    if dm is not None:
        sig._dm = make_quant(dm, "pc/cm^3")
    return sig


def fold_ensemble(config, device):
    """A ``FoldEnsemble`` of the configuration's pulsar on ``device``."""
    from psrsigsim_torch.models.pulsar import DataProfile, Pulsar
    from psrsigsim_torch.parallel import FoldEnsemble

    sig = fold_signal(config, dm=config["dm"])
    with contextlib.redirect_stdout(io.StringIO()):
        psr = Pulsar(config["period_s"], config["smean_jy"],
                     DataProfile(profile_data(config), phases=None,
                                 Nchan=config["nchan"]),
                     name=config["pulsar"], seed=0)
    return FoldEnsemble(sig, psr, telescope(config), "BenchSys",
                        device=device)


def msp_population(config):
    """The ensemble's pulsars, drawn with numpy from the configuration's
    population seed: ``[(period_s, smean_jy, peak, width, dm)]``, in the
    order the draws are made."""
    p = config["population"]
    rng = np.random.default_rng(p["seed"])
    out = []
    for _ in range(config["n_pulsars"]):
        period = p["period_lo_s"] + p["period_span_s"] * rng.random()
        smean = p["smean_lo_jy"] + p["smean_span_jy"] * rng.random()
        peak = p["peak_lo"] + p["peak_span"] * rng.random()
        width = p["width_lo"] + p["width_span"] * rng.random()
        dm = p["dm_lo"] + p["dm_span"] * rng.random()
        out.append((period, smean, peak, width, dm))
    return out


def multipulsar_ensemble(config, epoch_chunk, device):
    """A ``MultiPulsarFoldEnsemble`` of the configuration's population on
    ``device``, every pulsar on the padded bin grid, ``epoch_chunk``
    epochs a pass."""
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
    from psrsigsim_torch.simulate import build_fold_config, natural_nbin as nn

    tel = telescope(config)
    workloads = []
    for period, smean, peak, width, dm in msp_population(config):
        sig = fold_signal(config)
        with contextlib.redirect_stdout(io.StringIO()):
            psr = Pulsar(period, smean, GaussProfile(peak=peak, width=width),
                         name="MSP")
        nbin = MultiPulsarFoldEnsemble.choose_nbin(nn(sig, psr),
                                                   config["pad_nbin"])
        cfg, profiles, norm = build_fold_config(sig, psr, tel, "BenchSys",
                                                nbin=nbin)
        workloads.append((cfg, profiles, norm, dm))
    return MultiPulsarFoldEnsemble(workloads,
                                   epoch_chunk=epoch_chunk,
                                   device=device)
