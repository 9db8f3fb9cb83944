"""Pod program groups of the port on the CPU: a follower's death and the
resume, and a serving replica that is a pod group (the mirror of the JAX
package's tests/test_pod.py ``TestPodKill`` and ``TestPodFleetGroup``).

* ``pod.kill`` SIGKILLs the follower of a 2-process supervised export after
  its first chunk; the leader notices through the channel watchdog and
  exits with ``POD_PEER_EXIT`` (73) — never a hang — and a relaunch of the
  whole group resumes (``resume="verify"``) to the uninterrupted
  single-process run's bytes, computing only the missing chunks.
* ``ReplicaFleet(group_hosts=2, device="cpu")``: a leader with the HTTP
  endpoint and one follower serve profiles byte-identical to a
  single-process replica's; a SIGKILLed follower takes the leader down
  with exit 73 and the supervisor brings a fresh group back, serving the
  same bytes.

Geometry: the JAX package's tests/fault_runner.py ``SIM_CONFIG`` (copied
into psrsigsim_torch/tools/pod_runner.py), 16 observations in chunks of 4
over two mesh positions.  Every spawned process has a timeout.
"""

import glob
import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY", "PSS_POD_FETCH", "PSS_POD_COORDINATOR",
              "PSS_POD_NUM_PROCESSES", "PSS_POD_PROCESS_ID",
              "PSS_POD_CHANNEL_PORT"):
        monkeypatch.delenv(k, raising=False)


def _fits_bytes(out_dir):
    out = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.fits"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


class TestPodKill:
    """A follower SIGKILLed mid-run aborts the whole group loudly, and a
    clean relaunch resumes to byte-identical output."""

    N_OBS, CHUNK = 16, 4

    def test_follower_death_aborts_group_and_resume_is_byte_identical(
            self, tmp_path):
        from test_torch_pod import pod_runner

        from psrsigsim_torch.runtime.dist import POD_PEER_EXIT

        spawn_export_group = pod_runner().spawn_export_group

        # the uninterrupted single-process reference
        solo = str(tmp_path / "solo")
        (rc, _, err), = spawn_export_group(solo, 1, self.N_OBS, self.CHUNK,
                                           timeout=240, device="cpu")
        assert rc == 0, err[-3000:]
        want = _fits_bytes(solo)
        assert len(want) == self.N_OBS

        plan = str(tmp_path / "podkill.json")
        with open(plan, "w") as f:
            json.dump({"scratch_dir": str(tmp_path / "podkill_scratch"),
                       "spec": {"pod.kill": {"after_chunks": 2}}}, f)
        out = str(tmp_path / "pod")
        # depth 0: each chunk's exchange happens at its dispatch, one chunk
        # ahead of the loop's consumer, so the exchange of chunk k+2
        # follows the leader's commit of chunk k: a follower killed after
        # its loop passed chunk 1 leaves chunk 0 committed (chunk 1 too if
        # the leader's writes beat its watchdog) and the leader short of
        # chunk 3's exchange, which it can never finish.  The resume below
        # runs at the default depth
        t0 = time.monotonic()
        (lead_rc, _, lead_err), (fol_rc, _, fol_err) = spawn_export_group(
            out, 2, self.N_OBS, self.CHUNK, follower_plan=plan,
            timeout=240, pipeline_depth=0, device="cpu")
        assert fol_rc in (-9, 137), (fol_rc, fol_err[-3000:])
        assert lead_rc == POD_PEER_EXIT, (lead_rc, lead_err[-3000:])
        assert "peer process 1 died" in lead_err
        assert time.monotonic() - t0 < 120
        # it really died mid-run, after chunk 0's commit; what it wrote is
        # the clean bytes
        partial = _fits_bytes(out)
        assert self.CHUNK <= len(partial) < self.N_OBS
        assert all(partial[n] == want[n] for n in partial)
        with open(os.path.join(out, "run_journal.jsonl")) as fh:
            first = [json.loads(line)["ident"] for line in fh]
        assert first in ([0], [0, self.CHUNK])

        # the supervisor's restart: a fresh full group resumes
        res = spawn_export_group(out, 2, self.N_OBS, self.CHUNK,
                                 timeout=240, device="cpu")
        for rc, _, err in res:
            assert rc == 0, err[-3000:]
        assert _fits_bytes(out) == want
        # only the missing chunks were computed again: one commit a chunk
        with open(os.path.join(out, "run_journal.jsonl")) as fh:
            commits = [json.loads(line)["ident"] for line in fh
                       if json.loads(line)["e"] == "commit"]
        assert commits[:len(first)] == first
        assert sorted(commits) == list(range(0, self.N_OBS, self.CHUNK))
        lead, fol = (_last_json(o) for _, o, _ in res)
        assert lead["paths"] == self.N_OBS and lead["quarantined"] == []
        assert fol == dict(fol, pod_follower=1)


SERVE_SPEC = {
    "nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
    "period_s": 0.005, "smean_jy": 0.05, "seed": 3, "dm": 10.0,
}


class TestPodFleetGroup:
    """A fleet replica as a pod PROGRAM GROUP: byte-identical to a
    single-process replica, and a follower's death restarts the whole
    group."""

    SPECS = [dict(SERVE_SPEC, seed=700 + i, dm=10.0 + 0.5 * i)
             for i in range(3)]

    def _drive(self, fleet, specs, deadline_s=120.0):
        from psrsigsim_torch.serve.router import FleetRouter

        router = FleetRouter(fleet)
        shas = []
        for spec in specs:
            status, resp = router.submit(spec, deadline_s=deadline_s,
                                         wait=True)
            assert status == 200 and resp.get("status") == "done", (
                status, resp)
            shas.append(hashlib.sha256(
                json.dumps(resp["profile"]).encode()).hexdigest())
        return shas

    def test_group_serves_identical_and_survives_follower_death(
            self, tmp_path):
        import urllib.request

        from psrsigsim_torch.runtime.dist import POD_PEER_EXIT
        from psrsigsim_torch.serve.fleet import ReplicaFleet

        solo = ReplicaFleet(1, str(tmp_path / "solo_cache"), widths=(1, 8),
                            quorum=1, device="cpu", ready_timeout_s=120.0)
        solo.start()
        try:
            want = self._drive(solo, self.SPECS)
        finally:
            solo.drain()

        fleet = ReplicaFleet(1, str(tmp_path / "pod_cache"), widths=(1, 8),
                             quorum=1, group_hosts=2, device="cpu",
                             ready_timeout_s=120.0,
                             log_dir=str(tmp_path / "logs"))
        fleet.start()
        try:
            got = self._drive(fleet, self.SPECS)
            assert got == want
            (_, url), = fleet.endpoints()
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            assert health["pod"] == {"process_id": 0, "num_processes": 2,
                                     "is_pod": True}

            leader = fleet._sups[0].proc
            follower = fleet._group_procs[0][0]
            os.kill(follower.pid, 9)
            deadline = time.time() + 90
            while leader.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            # the leader died LOUDLY through the watchdog, not a hang
            assert leader.poll() == POD_PEER_EXIT, leader.poll()
            got2 = None
            while time.time() < deadline + 90:
                if (fleet._sups[0].alive() and fleet.endpoints()
                        and fleet._sups[0].proc is not leader):
                    try:
                        got2 = self._drive(fleet, self.SPECS[:1] + [
                            dict(SERVE_SPEC, seed=900)])
                        break
                    except AssertionError:
                        time.sleep(0.5)
                else:
                    time.sleep(0.25)
            assert got2 is not None, "pod group never recovered"
            assert got2[0] == want[0]
            assert fleet._sups[0].restarts >= 1
        finally:
            fleet.drain()
        assert np.all([p.poll() is not None
                       for p in fleet._group_procs.get(0, [])])


POD_RUNNER = os.path.join(ROOT, "psrsigsim_torch", "tools", "pod_runner.py")


def _runner(*argv, timeout=300):
    import subprocess

    proc = subprocess.run([sys.executable, POD_RUNNER, *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return _last_json(proc.stdout)


class TestPodRunnerModes:
    """The driver's other modes: a second pod builds nothing, and the
    bench reports a rate a host count."""

    def test_warm_join_builds_nothing(self):
        verdict = _runner("--mode", "warm", "--hosts", "2", "--families",
                          "ensemble", "--device", "cpu", "--total-devices",
                          "2", "--ens-chunk", "0", "--timeout", "150")
        assert verdict["ok"], verdict
        assert verdict["new_build_files_on_join"] == []
        assert verdict["hashes_equal"]

    def test_bench_reports_each_host_count(self):
        verdict = _runner("--mode", "bench", "--hosts", "1,2", "--device",
                          "cpu", "--devices-per-host", "1", "--ens-obs", "4",
                          "--timeout", "150")
        assert verdict["ok"] and sorted(verdict["levels"]) == ["1", "2"]
        for level in verdict["levels"].values():
            assert level["obs_per_sec"] > 0
        pod = verdict["levels"]["2"]["workers"]
        assert [w["process_id"] for w in pod] == [0, 1]
        assert all(w["exchange"]["exchanges"] == 4 for w in pod)
