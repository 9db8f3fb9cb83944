"""Simulation: the one-object convenience façade (counterpart:
psrsigsim_tpu/simulate/simulate.py).

Behavioral counterpart of psrsigsim/simulate/simulate.py — config via kwargs
or a flat dict, ``init_*`` builders, ``simulate()`` running the §3.1 call
stack, ``save_simulation()`` to PSRFITS/pdv.  For ensemble use,
:mod:`psrsigsim_torch.simulate.pipeline` runs the same chain over batches
of observations; ``Simulation.to_ensemble()`` bridges the two and
``Simulation.export_ensemble()`` writes an ensemble's PSRFITS files.

Everything the façade builds holds its data on one device: the CUDA card
unless ``device=`` names another (``device="cpu"``, as the CPU tests do);
``run_mc_study`` runs a Monte-Carlo study there; ``to_ensemble(scenario=
[...])`` adds the scenario engine's effects.  Meshes belong to a later
slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..models.ism import ISM
from ..models.pulsar import (
    DataPortrait,
    DataProfile,
    GaussPortrait,
    Pulsar,
    UserPortrait,
)
from ..models.telescope import Arecibo, Backend, GBT, Receiver, Telescope
from ..signal import FilterBankSignal
from ..utils.utils import make_par

__all__ = ["Simulation"]


class Simulation:
    """Convenience class for full simulations (reference:
    simulate/simulate.py:18-118; see that docstring for the parameter
    catalog — the surface here is the JAX package's: the reference's plus
    ``seed`` and ``ephemeris``; and ``device``, where the signal's data and
    the ensemble live, the CUDA card unless it names another)."""

    def __init__(self,
                 fcent=None,
                 bandwidth=None,
                 sample_rate=None,
                 dtype=np.float32,
                 Npols=1,
                 Nchan=512,
                 sublen=None,
                 fold=True,
                 period=None,
                 Smean=None,
                 profiles=None,
                 specidx=0.0,
                 ref_freq=None,
                 tobs=None,
                 name=None,
                 dm=None,
                 tau_d=None,
                 tau_d_ref_f=None,
                 aperture=None,
                 area=None,
                 Tsys=None,
                 tscope_name=None,
                 system_name=None,
                 rcvr_fcent=None,
                 rcvr_bw=None,
                 rcvr_name=None,
                 backend_samprate=None,
                 backend_name=None,
                 tempfile=None,
                 parfile=None,
                 psrdict=None,
                 seed=None,
                 ephemeris=None,
                 device=None):
        self._fcent = fcent
        self._bandwidth = bandwidth
        self._sample_rate = sample_rate
        self._dtype = dtype
        self._Npols = Npols
        self._Nchan = Nchan
        self._sublen = sublen
        self._fold = fold
        self._period = period
        self._Smean = Smean
        self._profiles = profiles
        self._specidx = specidx
        self._ref_freq = ref_freq
        self._tobs = tobs
        self._name = name
        self._dm = dm
        self._tau_d = tau_d
        self._tau_d_ref_f = tau_d_ref_f
        self._aperture = aperture
        self._area = area
        self._Tsys = Tsys
        self._tscope_name = tscope_name
        self._system_name = system_name
        self._rcvr_fcent = rcvr_fcent
        self._rcvr_bw = rcvr_bw
        self._rcvr_name = rcvr_name
        self._backend_samprate = backend_samprate
        self._backend_name = backend_name
        self._tempfile = tempfile
        self._seed = seed
        self._ephemeris = ephemeris
        self._device = device

        if parfile is not None:
            self.params_from_par(parfile)
        if psrdict is not None:
            self.params_from_dict(psrdict)
        if self._ephemeris is not None:
            # one obvious user path from "I have a .bsp" to JPL-grade
            # phase connection: pass ephemeris= (or an
            # "ephemeris" psrdict key) and every polyco/PSRFITS built
            # from this simulation barycenters on the kernel.  This IS
            # the process-global PSS_EPHEM / io.ephem.set_ephemeris
            # switch (barycentering has no per-instance state): it stays
            # active until changed, and a Simulation constructed WITHOUT
            # ephemeris= uses whatever is globally active.  Applied
            # loudly here so a bad path fails at construction, and
            # re-applied by every polyco-producing entry point
            # (_activate_ephemeris) so another instance cannot silently
            # swap kernels in between; set_ephemeris itself warns when
            # it replaces a different active kernel.  The PSRFITS EPHEM
            # card records the source either way.
            self._activate_ephemeris(warn=True)

    def _activate_ephemeris(self, warn=False):
        """Re-apply THIS instance's kernel to the process-global switch.

        Called at construction (``warn=True`` — replacing another
        instance's active kernel there IS the hazardous cross-coupling
        :class:`~psrsigsim_torch.io.ephem.EphemerisChangeWarning` exists
        for) and again, quietly, at every entry point that produces
        polycos (``save_simulation``, ``to_ensemble``): restoring our
        own stamped kernel is the sanctioned repair, not the hazard, and
        must not trip ``-W error`` suites.  A Simulation built without
        ``ephemeris=`` deliberately follows whatever is globally active
        and is left untouched here."""
        if self._ephemeris is not None:
            from ..io import ephem as _ephem

            _ephem.set_ephemeris(self._ephemeris, warn=warn)

    def params_from_dict(self, psrdict):
        """Apply a flat parameter dict (reference: simulate.py:188-193)."""
        for key in psrdict.keys():
            setattr(self, "_" + key, psrdict[key])

    def params_from_par(self, parfile):
        """Load pulsar parameters from a TEMPO/PINT-style .par file.

        Stubbed in the reference (simulate.py:195-199); completed in the
        JAX package (the root DIVERGENCES.md #15): PSR -> name, F0/F/P0 ->
        period, DM -> dm.
        Only spin/name/DM enter the simulation; other timing-model terms
        are left for the polyco stage, which validates them at save time
        (io/polyco.py).
        """
        from ..io import parse_par

        pars = parse_par(parfile)
        if "PSR" in pars:
            self._name = str(pars["PSR"])
        elif "PSRJ" in pars:
            self._name = str(pars["PSRJ"])
        if "F0" in pars:
            self._period = 1.0 / float(pars["F0"])
        elif "F" in pars:
            self._period = 1.0 / float(pars["F"])
        elif "P0" in pars:
            self._period = float(pars["P0"])
        if "DM" in pars:
            self._dm = float(pars["DM"])

    # -- builders ----------------------------------------------------------
    def init_signal(self, from_template=False):
        """Initialize the FilterBankSignal from parameters or a template
        PSRFITS file (reference: simulate.py:201-219)."""
        if from_template:
            from ..io import PSRFITS

            pfit = PSRFITS(path="sim_fits.fits", template=self.tempfile,
                           fits_mode="copy", obs_mode="PSR")
            self._signal = pfit.make_signal_from_psrfits()
            self._signal._device = (None if self._device is None
                                    else str(self._device))
        else:
            self._signal = FilterBankSignal(
                fcent=self.fcent, bandwidth=self.bw, Nsubband=self.Nchan,
                sample_rate=self.samprate, fold=self.fold, sublen=self.sublen,
                dtype=self.dtype, device=self._device,
            )

    def init_profile(self):
        """Resolve the profile input: class instance, [peak, width, amp]
        Gaussian triple, data array, or callable
        (reference: simulate.py:221-243)."""
        proftypes = (GaussPortrait, UserPortrait, DataPortrait, DataProfile)
        if isinstance(self.profiles, proftypes):
            return
        if isinstance(self.profiles, (list, np.ndarray)):
            if len(self.profiles) == 3:
                prof = GaussPortrait(peak=self.profiles[0],
                                     width=self.profiles[1],
                                     amp=self.profiles[2])
            elif len(self.profiles) > 3:
                prof = DataProfile(np.asarray(self.profiles), phases=None,
                                   Nchan=self.Nchan)
            else:
                raise RuntimeError("Input profile array has too few values!")
        elif callable(self.profiles):
            raise NotImplementedError()
        else:
            print("Warning: Unrecognized input profile type, defaulting to "
                  "Gaussian.")
            prof = GaussPortrait()
        self._profiles = prof

    def init_pulsar(self):
        """Build the Pulsar (requires init_profile first;
        reference: simulate.py:246-255)."""
        self._pulsar = Pulsar(period=self.period, Smean=self.Smean,
                              profiles=self.profiles, name=self.name,
                              specidx=self.specidx, ref_freq=self.ref_freq,
                              seed=self._seed)

    def init_ism(self):
        """reference: simulate.py:257-262"""
        self._ism = ISM()

    def init_telescope(self):
        """GBT/Arecibo by name, or a custom telescope + system lists
        (reference: simulate.py:264-290)."""
        if self.tscope_name == "GBT":
            tscope = GBT()
        elif self.tscope_name == "Arecibo":
            tscope = Arecibo()
        else:
            tscope = Telescope(self.aperture, area=self.area, Tsys=self.Tsys,
                               name=self.tscope_name)
        if isinstance(self.rcvr_fcent, list):
            lengths = {
                len(self.system_name), len(self.rcvr_fcent), len(self.rcvr_bw),
                len(self.rcvr_name), len(self.backend_samprate),
                len(self.backend_name),
            }
            if len(lengths) != 1:
                raise RuntimeError("Number of telescope system entries do not match!")
            for ii in range(len(self.rcvr_fcent)):
                tscope.add_system(
                    name=self.system_name[ii],
                    receiver=Receiver(fcent=self.rcvr_fcent[ii],
                                      bandwidth=self.rcvr_bw[ii],
                                      name=self.rcvr_name[ii]),
                    backend=Backend(samprate=self.backend_samprate[ii],
                                    name=self.backend_name[ii]),
                )
        elif self.rcvr_fcent is not None:
            tscope.add_system(
                name=self.system_name,
                receiver=Receiver(fcent=self.rcvr_fcent, bandwidth=self.rcvr_bw,
                                  name=self.rcvr_name),
                backend=Backend(samprate=self.backend_samprate,
                                name=self.backend_name),
            )
        self._tscope = tscope

    # -- run ---------------------------------------------------------------
    def simulate(self, from_template=False):
        """Run the full §3.1 pipeline (reference: simulate.py:292-326).

        Note: like the reference (simulate.py:306), the signal is always
        initialized from parameters here — ``from_template`` is accepted for
        interface parity but not forwarded.
        """
        self.init_signal(from_template=False)
        self.init_profile()
        self.init_pulsar()
        self.init_ism()
        if self.tau_d is not None:
            self.ism.scatter_broaden(self.signal, self.tau_d, self.tau_d_ref_f,
                                     convolve=True, pulsar=self.pulsar)
        self.pulsar.make_pulses(self.signal, tobs=self.tobs)
        self.ism.disperse(self.signal, self.dm)
        self.init_telescope()
        self.tscope.observe(self.signal, self.pulsar, system=self.system_name,
                            noise=True)

    def init_all(self):
        """Initialize every simulation object (signal, profile, pulsar,
        telescope) and stamp tobs/dm onto the signal — the configuration
        half of ``simulate()``, shared by the ensemble entry points."""
        from ..utils.quantity import make_quant

        self.init_signal()
        self.init_profile()
        self.init_pulsar()
        self.init_telescope()
        self.signal._tobs = make_quant(self.tobs, "s")
        if self.dm is not None:
            self.signal._dm = make_quant(self.dm, "pc/cm^3")
        return self

    def to_ensemble(self, mesh=None, scenario=None):
        """Bridge to the ensemble runner: the same configuration as a
        :class:`~psrsigsim_torch.parallel.FoldEnsemble` on this simulation's
        device, with its ``ephemeris_source`` stamped.

        ``scenario``: optional list of scenario-effect labels (or a
        :class:`~psrsigsim_torch.scenarios.ScenarioStack`) enabling the
        scenario engine's effects on every run of the ensemble — see
        :mod:`psrsigsim_torch.scenarios`.  ``mesh``: an ``(obs, chan)``
        device mesh (:func:`~psrsigsim_torch.parallel.make_mesh`); the
        ensemble then runs over it and its results land on the mesh's
        first device, which must be this simulation's device when one was
        named."""
        from ..parallel.ensemble import FoldEnsemble
        from ..parallel.mesh import mesh_devices

        # the ensemble's PSRFITS exit path fits polycos: make sure they
        # barycenter on THIS instance's kernel, not whichever Simulation
        # touched the global switch last — applied now, and stamped on
        # the ensemble so export_ensemble_psrfits re-applies it at export
        # time (another Simulation may run in between)
        self._activate_ephemeris()
        self.init_all()
        mesh, device = mesh_devices(mesh, self._device)
        ens = FoldEnsemble(self.signal, self.pulsar, self.tscope,
                           self.system_name, device=device,
                           scenario=scenario, mesh=mesh)
        ens.ephemeris_source = self._ephemeris
        return ens

    def export_ensemble(self, n_obs, out_dir, template=None, mesh=None,
                        supervised=True, scenario=None, **export_kw):
        """Export ``n_obs`` Monte-Carlo observations of this simulation as
        PSRFITS files — the bulk counterpart of :meth:`save_simulation`.

        Builds the ensemble (:meth:`to_ensemble`) and streams it through
        the PSRFITS bulk exporter.  ``supervised=True`` (default) routes
        through :func:`psrsigsim_torch.runtime.supervised_export`:
        crash-safe journaled output, sha256-verified resume, and the NaN
        quarantine — the configuration every long-running production export
        should use — and returns its
        :class:`~psrsigsim_torch.runtime.RunResult`.  ``supervised=False``
        calls the bare exporter
        (:func:`psrsigsim_torch.io.export_ensemble_psrfits`) and returns the
        path list.

        ``template`` defaults to this simulation's ``tempfile``;
        ``export_kw`` is forwarded (seed, dms, noise_norms, chunk_size,
        writers, obs_per_file, resume — including ``resume="verify"``
        under supervision — and ``scenario_params``).  ``scenario`` builds
        the ensemble with that scenario stack (:meth:`to_ensemble`); the
        JAX package's façade has no such keyword, its callers export a
        scenario ensemble through the exporter directly.  ``mesh``: as
        :meth:`to_ensemble` (the files are the mesh-free export's bytes).
        """
        if template is None:
            template = self.tempfile
        if template is None:
            raise RuntimeError("No template PSRFITS file provided.")
        ens = self.to_ensemble(mesh=mesh, scenario=scenario)
        if supervised:
            from ..runtime import supervised_export

            return supervised_export(ens, n_obs, out_dir, template,
                                     self.pulsar, **export_kw)
        from ..io import export_ensemble_psrfits

        return export_ensemble_psrfits(ens, n_obs, out_dir, template,
                                       self.pulsar, **export_kw)

    def run_mc_study(self, priors, n_trials, seed=0, out_dir=None,
                     mesh=None, study_kw=None, **run_kw):
        """Run a Monte-Carlo study over this simulation's configuration,
        on its device — the one-call bridge to :mod:`psrsigsim_torch.mc`.

        ``priors`` is ``{knob: Prior-or-spec-dict}`` (knobs:
        :data:`psrsigsim_torch.mc.KNOBS`; e.g. ``{"dm": Uniform(10,
        20)}``).  Builds a :class:`~psrsigsim_torch.mc.MonteCarloStudy` via
        :meth:`MonteCarloStudy.from_simulation` (so
        :meth:`~psrsigsim_torch.mc.MonteCarloStudy.export_psrfits` works on
        it afterwards), runs ``n_trials`` trials, and returns the
        :class:`~psrsigsim_torch.mc.StudyResult`.  ``out_dir`` enables the
        crash-safe journal and the fingerprinted artifact; ``study_kw``
        passes construction options (``nharm``, ``hist_bins``, ...) and
        ``run_kw`` run options (``chunk_size``, ``resume``, ``telemetry``,
        ``progress``, ...).  ``mesh``: an ``(obs, chan)`` mesh with chan
        axis 1, over which the trials split.
        """
        from ..mc import MonteCarloStudy

        study = MonteCarloStudy.from_simulation(
            self, priors, seed=seed, mesh=mesh, **(study_kw or {}))
        return study.run(n_trials, out_dir=out_dir, **run_kw)

    def save_simulation(self, outfile="simfits", out_format="psrfits",
                        parfile=None, ref_MJD=56000.0, MJD_start=55999.9861):
        """Save simulated data as PSRFITS (template required) or PSRCHIVE
        pdv text (reference: simulate.py:328-377)."""
        if out_format.lower() == "psrfits":
            if outfile == "simfits":
                outfile += ".fits"
            if self.tempfile is None:
                raise RuntimeError("No template PSRFITS file provided.")
            from ..io import PSRFITS

            pfit = PSRFITS(path=outfile, template=self.tempfile,
                           fits_mode="copy", obs_mode="PSR")
            pfit.get_signal_params(signal=self.signal)
            if parfile is None:
                print("Warning: No par file provided, attempting to make one...")
                make_par(self.signal, self.pulsar, outpar="simpar.par")
                parfile = "simpar.par"
            # say which solar-system ephemeris barycenters this file (the
            # EPHEM card records it; the analytic default carries a
            # few-ms absolute offset vs a JPL kernel — io/ephem.py).
            # Re-activate this instance's kernel first: the switch is
            # process-global, and another Simulation may have changed it
            from ..io import ephem as _ephem

            self._activate_ephemeris()
            print("Ephemeris: %s" % _ephem.ephemeris_name())
            pfit.save(self.signal, self.pulsar, parfile=parfile,
                      MJD_start=MJD_start, segLength=60.0, ref_MJD=ref_MJD,
                      usePint=True)
        elif out_format.lower() == "pdv":
            from ..io import TxtFile

            if outfile == "simfits":
                outfile += ".ar"
            txtfile = TxtFile(path=outfile)
            txtfile.save_psrchive_pdv(self.signal, self.pulsar)
        else:
            raise RuntimeError(
                "Unrecognized output file format: %s" % (out_format)
            )

    # -- properties (reference: simulate.py:381-511) -----------------------
    @property
    def fold(self):
        return self._fold

    @property
    def sublen(self):
        return self._sublen

    @property
    def Nchan(self):
        return self._Nchan

    @property
    def fcent(self):
        return self._fcent

    @property
    def bw(self):
        return self._bandwidth

    @property
    def tobs(self):
        return self._tobs

    @property
    def samprate(self):
        return self._sample_rate

    @property
    def dtype(self):
        return self._dtype

    @property
    def Npols(self):
        return self._Npols

    @property
    def dm(self):
        return self._dm

    @property
    def tau_d(self):
        return self._tau_d

    @property
    def tau_d_ref_f(self):
        return self._tau_d_ref_f

    @property
    def profiles(self):
        return self._profiles

    @property
    def name(self):
        return self._name

    @property
    def period(self):
        return self._period

    @property
    def Smean(self):
        return self._Smean

    @property
    def specidx(self):
        return self._specidx

    @property
    def ref_freq(self):
        return self._ref_freq

    @property
    def tscope_name(self):
        return self._tscope_name

    @property
    def area(self):
        return self._area

    @property
    def aperture(self):
        return self._aperture

    @property
    def Tsys(self):
        return self._Tsys

    @property
    def system_name(self):
        return self._system_name

    @property
    def rcvr_fcent(self):
        return self._rcvr_fcent

    @property
    def rcvr_bw(self):
        return self._rcvr_bw

    @property
    def rcvr_name(self):
        return self._rcvr_name

    @property
    def backend_samprate(self):
        return self._backend_samprate

    @property
    def backend_name(self):
        return self._backend_name

    @property
    def tempfile(self):
        return self._tempfile

    @property
    def signal(self):
        return self._signal

    @property
    def pulsar(self):
        return self._pulsar

    @property
    def ism(self):
        return self._ism

    @property
    def tscope(self):
        return self._tscope
