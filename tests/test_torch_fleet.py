"""The port's serving fleet in process, on the CPU: a mirror of every
non-``slow`` test of tests/test_fleet.py (retry jitter, the hot and
shared cache tiers, journal compaction, the pooled transport, the process
supervisor, the router's routing, failover, breakers and edge cases, load
shedding, cache write failures and the elastic fleet), on
``psrsigsim_torch``'s modules with the same stub fleets and transports.

The router and fleet tests run against stub fleets, injected transports
and stub replica processes — no sockets to a real replica, no torch in the
children; the ``SimulationService`` ones pass ``device="cpu"``.  The
subprocess proofs and the comparisons with the JAX package are in
tests/test_torch_fleet_proofs.py.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from psrsigsim_torch.runtime import ProcessSupervisor, RetryPolicy
from psrsigsim_torch.runtime.faults import FaultPlan
from psrsigsim_torch.serve import FleetRouter, RequestRejected, ResultCache
from psrsigsim_torch.serve.router import RouteFailed


#: a valid minimal spec for router tests (canonicalization is real)
SPEC = {
    "nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
    "period_s": 0.005, "smean_jy": 0.05, "seed": 3, "dm": 10.0,
}


# ---------------------------------------------------------------------------
# retry jitter
# ---------------------------------------------------------------------------


class TestRetryJitter:
    def test_default_is_exact_deterministic_schedule(self):
        p = RetryPolicy(max_attempts=4, base_delay=0.5, max_delay=30.0)
        assert p.delays() == [0.5, 1.0, 2.0]

    def test_injected_rng_reproducible_and_bounded(self):
        mk = lambda seed: RetryPolicy(max_attempts=6, base_delay=0.5,
                                      max_delay=30.0, jitter=0.5,
                                      rng=random.Random(seed).random)
        assert mk(7).delays() == mk(7).delays()
        assert mk(7).delays() != mk(8).delays()      # decorrelated fleets
        det = RetryPolicy(max_attempts=6, base_delay=0.5, max_delay=30.0)
        for d, dd in zip(mk(7).delays(), det.delays()):
            assert dd * 0.5 <= d <= min(30.0, dd * 1.5)

    def test_jitter_band_respects_max_delay_cap(self):
        p = RetryPolicy(max_attempts=12, base_delay=1.0, max_delay=4.0,
                        jitter=1.0, rng=random.Random(1).random)
        assert all(d <= 4.0 for d in p.delays())

    def test_jitter_validation(self):
        with pytest.raises(ValueError):
            RetryPolicy(jitter=1.5)
        with pytest.raises(ValueError):
            RetryPolicy(jitter=-0.1)


# ---------------------------------------------------------------------------
# in-memory hot tier
# ---------------------------------------------------------------------------


def _cache(d, **kw):
    kw.setdefault("hot_tail_check_s", 0.0)   # deterministic coherence
    return ResultCache(str(d), **kw)


class TestHotTier:
    def test_hot_hit_after_commit_reads_no_disk(self, tmp_path):
        """An artifact committed by THIS process serves from memory:
        zero disk reads, zero re-hashing (the viral-spec_hash fix)."""
        c = _cache(tmp_path / "c", hot_max_bytes=1 << 20)
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.put("aa" * 32, arr)
        for _ in range(3):
            got = c.get("aa" * 32)
            assert got.tobytes() == arr.tobytes()
        s = c.stats()
        assert s["hot_hits"] == 3 and s["disk_hits"] == 0
        assert s["hot_entries"] == 1 and s["hot_bytes"] > 0
        c.close()

    def test_hot_and_disk_tiers_byte_identical(self, tmp_path):
        """A fresh reader's first get decodes from disk; its second is
        hot — and a hot-disabled reader re-reads from disk every time.
        All three paths must produce identical bytes."""
        d = tmp_path / "c"
        w = _cache(d, hot_max_bytes=1 << 20)
        arr = np.linspace(0, 1, 48, dtype=np.float32).reshape(4, 12)
        w.put("bb" * 32, arr)
        hot = w.get("bb" * 32)                     # committer: hot
        r = _cache(d, hot_max_bytes=1 << 20)
        disk = r.get("bb" * 32)                    # fresh: disk decode
        hot2 = r.get("bb" * 32)                    # then hot
        cold = _cache(d, hot_max_bytes=0)
        nodisk = cold.get("bb" * 32)               # hot disabled
        assert (hot.tobytes() == disk.tobytes() == hot2.tobytes()
                == nodisk.tobytes() == arr.astype(np.float32).tobytes())
        assert r.stats()["disk_hits"] == 1 and r.stats()["hot_hits"] == 1
        assert cold.stats()["hot_hits"] == 0
        for c in (w, r, cold):
            c.close()

    def test_disk_read_memo_skips_reopen_until_journal_moves(
            self, tmp_path):
        """With the hot tier disabled, repeated gets of the SAME hash
        must not re-open and re-decode the artifact — the (hash, inode,
        size) memo of the last verified read serves them — until the
        journal tail moves."""
        d = tmp_path / "c"
        w = _cache(d, hot_max_bytes=0)
        arr = np.full((2, 8), 7.0, np.float32)
        w.put("cc" * 32, arr)
        r = _cache(d, hot_max_bytes=0)
        assert r.get("cc" * 32) is not None        # disk read
        assert r.get("cc" * 32) is not None        # memo
        assert r.get("cc" * 32) is not None        # memo
        s = r.stats()
        assert s["disk_hits"] == 1 and s["memo_hits"] == 2
        # journal tail moves (peer commit): memo for OTHER hash useless,
        # but the same hash still serves (refresh keeps its record live)
        w.put("dd" * 32, arr)
        assert r.get("cc" * 32) is not None
        w.close(), r.close()

    def test_peer_verify_drop_evicts_hot_entry(self, tmp_path):
        """Cross-process coherence: a peer's journaled verify-drop must
        evict this process's hot entry (journal-tail heartbeat), not be
        masked by it."""
        d = tmp_path / "c"
        a = _cache(d, hot_max_bytes=1 << 20)
        arr = np.ones((3, 4), np.float32)
        a.put("ee" * 32, arr)
        assert a.get("ee" * 32) is not None        # hot in a
        with open(os.path.join(str(d), "results", "ee" * 32 + ".npy"),
                  "wb") as f:
            f.write(b"torn")
        # the relaunched-peer path: a fresh reader indexes the commit,
        # re-hashes, finds the torn artifact, journals the drop
        b = _cache(d, hot_max_bytes=1 << 20, verify=True)
        assert b.dropped == 1
        assert a.get("ee" * 32) is None            # heartbeat saw it
        assert a.stats()["hot_entries"] == 0
        a.close(), b.close()

    def test_lru_byte_bound_under_concurrent_put_get(self, tmp_path):
        """The byte budget holds under concurrent put/get from many
        threads, every get returns correct bytes, and evictions are
        counted."""
        c = _cache(tmp_path / "c", hot_max_bytes=600)
        arrs = {f"{i:02d}" * 32: np.full((3, 8), float(i), np.float32)
                for i in range(12)}
        errs = []

        def worker(keys):
            try:
                for _ in range(5):
                    for h in keys:
                        c.put(h, arrs[h])
                        got = c.get(h)
                        if got is not None \
                                and got.tobytes() != arrs[h].tobytes():
                            errs.append(h)
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

        keys = list(arrs)
        threads = [threading.Thread(target=worker,
                                    args=(keys[i::3],))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        s = c.stats()
        assert not errs
        assert s["hot_bytes"] <= 600
        assert s["hot_evictions"] > 0
        # and the durable tier is intact underneath
        for h in keys:
            assert c.get(h).tobytes() == arrs[h].tobytes()
        c.close()

    def test_enospc_at_journal_leaves_no_hot_entry(self, tmp_path):
        """The SIGKILL/ENOSPC-mid-commit pin: an artifact that never
        reached the journal must have no hot entry — hot population
        happens strictly AFTER the journal record is durable."""
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"cache.enospc": {"at": "journal", "times": 1}})
        c = _cache(tmp_path / "c", faults=plan, hot_max_bytes=1 << 20)
        with pytest.raises(OSError):
            c.put("ff" * 32, np.ones(4, np.float32))
        s = c.stats()
        assert s["hot_entries"] == 0
        assert c.get("ff" * 32) is None
        c.close()

    def test_dead_writer_tmp_swept_at_open(self, tmp_path):
        """A SIGKILLed writer's partial artifact tmp (named with its
        pid) is reaped at the next open; a LIVE writer's tmp is not."""
        d = tmp_path / "c"
        c = _cache(d)
        c.put("aa" * 32, np.ones(4, np.float32))
        c.close()
        results = os.path.join(str(d), "results")
        dead = os.path.join(results, f"{'bb' * 32}.npy.999999.1.tmp")
        live = os.path.join(results, f"{'cc' * 32}.npy.{os.getpid()}.1.tmp")
        for p in (dead, live):
            with open(p, "wb") as f:
                f.write(b"partial")
        c2 = _cache(d)
        assert not os.path.exists(dead)
        assert os.path.exists(live)        # we are alive: not ours to reap
        assert c2.stats()["tmp_sweeps"] == 1
        c2.close()
        os.unlink(live)


# ---------------------------------------------------------------------------
# pooled keep-alive transport
# ---------------------------------------------------------------------------


class TestPooledTransport:
    @pytest.fixture
    def tiny_server(self):
        """A minimal keep-alive JSON HTTP server (stdlib only)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"path": self.path}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_POST = do_GET

        srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield f"http://127.0.0.1:{srv.server_port}"
        srv.shutdown()
        srv.server_close()

    def test_second_request_reuses_pooled_socket(self, tiny_server):
        from psrsigsim_torch.serve.router import PooledTransport

        tp = PooledTransport(pool_size=4)
        s1, _ = tp("GET", tiny_server + "/a", None, 10)
        s2, _ = tp("GET", tiny_server + "/b", None, 10)
        assert s1 == s2 == 200
        st = tp.stats()
        assert st["misses"] == 1 and st["hits"] == 1
        assert tp.open_count(tiny_server) == 1
        tp.close()

    def test_pool_size_cap(self, tiny_server):
        from psrsigsim_torch.serve.router import PooledTransport

        tp = PooledTransport(pool_size=2)
        # 4 concurrent checkouts -> 4 sockets; only 2 may be pooled
        conns = [tp._checkout(tp._netloc(tiny_server)) for _ in range(4)]
        import http.client
        from urllib.parse import urlsplit

        u = urlsplit(tiny_server)
        for conn, epoch in conns:
            if conn is None:
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=10)
            tp._checkin(tp._netloc(tiny_server), conn, epoch)
        assert tp.open_count(tiny_server) <= 2
        tp.close()

    def test_evict_closes_pooled_and_invalidates_inflight(
            self, tiny_server):
        from psrsigsim_torch.serve.router import PooledTransport

        tp = PooledTransport(pool_size=4)
        tp("GET", tiny_server + "/a", None, 10)
        assert tp.open_count(tiny_server) == 1
        # an in-flight socket checked out BEFORE the eviction...
        conn, epoch = tp._checkout(tp._netloc(tiny_server))
        assert conn is not None
        tp.evict(tiny_server)
        assert tp.open_count(tiny_server) == 0
        # ...is closed at checkin instead of re-entering the pool
        tp._checkin(tp._netloc(tiny_server), conn, epoch)
        assert tp.open_count(tiny_server) == 0
        assert tp.stats()["evictions"] >= 1
        tp.close()

    def test_stale_pooled_socket_retries_once_then_raises(self):
        """A pooled socket silently closed by the server (idle reap, a
        restart): the reused-socket failure retries ONCE on a fresh
        connection (keep-alive discipline) and succeeds invisibly; once
        the server is truly gone, the fresh connection's failure
        propagates — the failover trigger."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from psrsigsim_torch.serve.router import PooledTransport

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")
                # close WITHOUT advertising it: the client pools a
                # socket the server has already abandoned — exactly
                # the stale-reuse case
                self.close_connection = True

        srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_port}"
        tp = PooledTransport(pool_size=4)
        assert tp("GET", url + "/x", None, 10)[0] == 200
        assert tp.open_count(url) == 1
        # reuse hits the abandoned socket -> ONE invisible fresh retry
        assert tp("GET", url + "/x", None, 10)[0] == 200
        assert tp.stats()["stale_retries"] == 1
        srv.shutdown()
        srv.server_close()                 # listener gone: fresh conns fail
        with pytest.raises((OSError, ConnectionError)):
            tp("GET", url + "/x", None, 5)
        tp.close()

    def test_router_default_transport_is_pooled_with_stats(self):
        class StubFleet:
            def endpoints(self):
                return []

            def has_quorum(self):
                return True

        r = FleetRouter(StubFleet())
        assert "pool" in r.stats()
        r.close()


# ---------------------------------------------------------------------------
# cross-process cache commit discipline
# ---------------------------------------------------------------------------


class TestSharedCacheTier:
    def test_peer_commit_visible_without_reopen(self, tmp_path):
        """Two cache instances over one dir (flock excludes even
        same-process instances): a commit by one is served by the other
        via the journal-tail refresh — the shared-tier contract."""
        d = str(tmp_path / "c")
        a, b = ResultCache(d), ResultCache(d)
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        a.put("aa" * 32, arr)
        got = b.get("aa" * 32)
        assert got is not None and got.tobytes() == arr.tobytes()
        a.close(), b.close()

    def test_duplicate_put_is_benign_noop(self, tmp_path):
        d = str(tmp_path / "c")
        a, b = ResultCache(d), ResultCache(d)
        arr = np.ones(4, np.float32)
        ra = a.put("aa" * 32, arr)
        rb = b.put("aa" * 32, arr)          # concurrent duplicate
        assert ra["sha256"] == rb["sha256"]
        with open(os.path.join(d, "cache_journal.jsonl")) as f:
            puts = [json.loads(l) for l in f if json.loads(l)["e"] == "put"]
        assert len(puts) == 1               # exactly one committed record
        a.close(), b.close()

    def test_stale_claim_from_dead_writer_is_broken(self, tmp_path):
        """A writer SIGKILL'd between artifact rename and journal append
        leaves a claim marker and an unindexed file; the next writer for
        that hash must break the claim and commit cleanly."""
        d = str(tmp_path / "c")
        h = "bb" * 32
        c0 = ResultCache(d)
        c0.close()
        claim = os.path.join(d, "claims", f"{h}.claim")
        with open(claim, "w") as f:
            f.write("dead-writer")
        os.utime(claim, (0, 0))             # ancient: instantly stale
        c = ResultCache(d, claim_timeout_s=0.5)
        rec = c.put(h, np.ones(3, np.float32))
        assert rec["hash"] == h and c.claim_breaks == 1
        assert not os.path.exists(claim)
        assert c.get(h) is not None
        c.close()

    def test_reader_never_indexes_unjournaled_artifact(self, tmp_path):
        """Commit order is artifact-then-journal: an artifact file with
        no journal record (the mid-commit crash window) must be
        invisible to readers."""
        d = str(tmp_path / "c")
        c = ResultCache(d)
        orphan = os.path.join(d, "results", "cc" * 32 + ".npy")
        np.save(orphan, np.zeros(3, np.float32))
        assert c.get("cc" * 32) is None
        c.close()
        c2 = ResultCache(d, verify=True)
        assert c2.get("cc" * 32) is None
        c2.close()

    def test_verify_drop_is_journaled_and_stays_dropped(self, tmp_path):
        d = str(tmp_path / "c")
        c = ResultCache(d)
        c.put("aa" * 32, np.zeros(4, np.float32))
        c.put("bb" * 32, np.ones(4, np.float32))
        c.close()
        path = os.path.join(d, "results", "aa" * 32 + ".npy")
        with open(path, "r+b") as f:
            f.seek(-2, os.SEEK_END)
            f.write(b"XX")
        c2 = ResultCache(d, verify=True)
        assert c2.verified == 1 and c2.dropped == 1
        c2.close()
        # a LATER open (no verify) must not resurrect the dropped record
        c3 = ResultCache(d)
        assert c3.get("aa" * 32) is None
        assert c3.get("bb" * 32) is not None
        c3.close()

    def test_concurrent_same_hash_puts_across_threads(self, tmp_path):
        d = str(tmp_path / "c")
        caches = [ResultCache(d) for _ in range(4)]
        arr = np.full((2, 8), 7.0, np.float32)
        errs = []

        def put(c):
            try:
                c.put("dd" * 32, arr)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=put, args=(c,)) for c in caches]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs
        with open(os.path.join(d, "cache_journal.jsonl")) as f:
            puts = [l for l in f if '"put"' in l]
        assert len(puts) == 1
        for c in caches:
            got = c.get("dd" * 32)
            assert got is not None and got.tobytes() == arr.tobytes()
            c.close()


class TestJournalCompaction:
    def _churn(self, d, n):
        """Commit n artifacts then verify-drop them all (dead records)."""
        c = ResultCache(d)
        for i in range(n):
            c.put(f"{i:02x}" * 32, np.zeros(2, np.float32))
        c.close()
        for i in range(n):
            p = os.path.join(d, "results", f"{i:02x}" * 32 + ".npy")
            with open(p, "r+b") as f:
                f.write(b"XX")
        v = ResultCache(d, verify=True)
        assert v.dropped == n
        v.close()

    def test_open_compacts_dead_history(self, tmp_path):
        d = str(tmp_path / "c")
        self._churn(d, 8)                      # 8 puts + 8 drops dead
        jp = os.path.join(d, "cache_journal.jsonl")
        assert len(open(jp).readlines()) == 16
        c = ResultCache(d, compact_min_dead=8)
        assert c.compacted == 16
        assert open(jp).readlines() == []      # nothing live survived
        c.close()

    def test_restart_count_journal_stays_bounded(self, tmp_path):
        """Repeated churn + reopen cycles must NOT
        grow the journal without bound — each open compacts once the
        dead-record count passes the threshold."""
        d = str(tmp_path / "c")
        sizes = []
        for cycle in range(5):
            c = ResultCache(d, compact_min_dead=6)
            for i in range(4):
                c.put(f"{cycle:02d}{i:02d}" + "ef" * 30,
                      np.zeros(2, np.float32))
            # drop this cycle's artifacts so history is all dead
            for i in range(4):
                p = os.path.join(d, "results",
                                 f"{cycle:02d}{i:02d}" + "ef" * 30 + ".npy")
                with open(p, "r+b") as f:
                    f.write(b"XX")
            c.close()
            v = ResultCache(d, verify=True, compact_min_dead=6)
            v.close()
            jp = os.path.join(d, "cache_journal.jsonl")
            sizes.append(len(open(jp).readlines()))
        # without compaction this grows by 8 lines per cycle (4 puts +
        # 4 drops); with it, every open clears the dead history
        assert max(sizes) <= 14, sizes
        assert sizes[-1] <= 14, sizes

    def test_live_entries_survive_compaction_and_peers_refresh(
            self, tmp_path):
        d = str(tmp_path / "c")
        keep = ResultCache(d)
        keep.put("aa" * 32, np.ones(3, np.float32))   # stays live
        self._churn(d, 8)
        c = ResultCache(d, compact_min_dead=8)        # compacts
        assert c.get("aa" * 32) is not None
        # the pre-compaction instance appends through the new inode and
        # refreshes across the swap
        keep.put("bb" * 32, np.zeros(3, np.float32))
        assert c.get("bb" * 32) is not None
        keep.close(), c.close()


# ---------------------------------------------------------------------------
# replica supervision
# ---------------------------------------------------------------------------


class TestProcessSupervisor:
    def test_restart_after_kill_and_clean_stop(self):
        sup = ProcessSupervisor(
            "t", lambda: subprocess.Popen(
                [sys.executable, "-c", "import time; time.sleep(60)"]),
            policy=RetryPolicy(max_attempts=5, base_delay=0.05,
                               max_delay=0.1))
        sup.start()
        assert sup.alive()
        pid1 = sup.pid
        sup.kill()
        deadline = time.time() + 30
        while time.time() < deadline:
            if sup.alive() and sup.restarts == 1:
                break
            time.sleep(0.05)
        assert sup.alive() and sup.pid != pid1 and sup.restarts == 1
        sup.stop()
        assert not sup.alive() and not sup.failed

    def test_flapping_child_exhausts_policy_and_fails(self):
        spawns = []

        def spawn():
            p = subprocess.Popen([sys.executable, "-c", "pass"])
            spawns.append(p.pid)
            return p

        sup = ProcessSupervisor(
            "flap", spawn,
            policy=RetryPolicy(max_attempts=3, base_delay=0.01,
                               max_delay=0.02))
        sup.start()
        deadline = time.time() + 30
        while time.time() < deadline and not sup.failed:
            time.sleep(0.05)
        assert sup.failed and len(spawns) == 3
        assert not sup.alive()


# ---------------------------------------------------------------------------
# consistent routing + failover (stub fleet, injected transport)
# ---------------------------------------------------------------------------


class _StubFleet:
    """An in-memory fleet: live replica ids with fake urls, a kill log,
    and per-replica behavior installed by the test."""

    def __init__(self, ids, quorum=1):
        self.live = {i: f"stub://replica{i}" for i in ids}
        self.quorum = quorum
        self.killed = []

    def endpoints(self):
        return sorted(self.live.items())

    def has_quorum(self):
        return len(self.live) >= self.quorum

    def kill_replica(self, i, sig=None):
        self.killed.append(i)
        self.live.pop(i, None)

    def health(self):
        return {"ok": self.has_quorum(), "healthy": len(self.live)}


def _ok_transport(log):
    def transport(method, url, body, timeout):
        log.append((method, url))
        return 200, {"status": "done", "url": url,
                     "profile": [[1.0]], "id": "x"}
    return transport


class TestFleetRouter:
    def test_routing_is_consistent_and_coalesces_identical_specs(self):
        fleet = _StubFleet([0, 1, 2])
        log = []
        r = FleetRouter(fleet, transport=_ok_transport(log))
        s1, b1 = r.submit(SPEC, deadline_s=5)
        s2, b2 = r.submit(dict(SPEC), deadline_s=5)   # identical content
        assert b1["url"] == b2["url"]                 # same replica: coalesce
        # distinct specs spread (statistically certain over 32 seeds)
        urls = set()
        for seed in range(32):
            _, b = r.submit(dict(SPEC, seed=seed), deadline_s=5)
            urls.add(b["url"])
        assert len(urls) == 3

    def test_death_moves_only_the_dead_replicas_keys(self):
        fleet = _StubFleet([0, 1, 2])
        r = FleetRouter(fleet, transport=_ok_transport([]))
        owners = {s: r.route(f"{s:064x}")[0] for s in range(64)}
        dead = 1
        fleet.live.pop(dead)
        for s, owner in owners.items():
            new_owner = r.route(f"{s:064x}")[0]
            if owner != dead:
                assert new_owner == owner     # surviving keys unmoved
            else:
                assert new_owner != dead

    def test_failover_preserves_deadline_and_reroutes(self):
        fleet = _StubFleet([0, 1])
        calls = []

        def transport(method, url, body, timeout):
            calls.append((url, json.loads(body)["deadline_s"], timeout))
            if len(calls) == 1:
                time.sleep(0.2)
                raise ConnectionError("replica died mid-request")
            return 200, {"status": "done", "url": url, "profile": [[1.0]]}

        r = FleetRouter(fleet, transport=transport)
        status, resp = r.submit(SPEC, deadline_s=30)
        assert status == 200
        assert len(calls) == 2 and calls[0][0] != calls[1][0]
        # the re-route carried the REMAINING budget, not a fresh one
        assert calls[1][1] < calls[0][1] - 0.15
        assert r.stats()["failovers"] == 1

    def test_below_quorum_rejects_with_backpressure(self):
        fleet = _StubFleet([0, 1], quorum=2)
        r = FleetRouter(fleet, transport=_ok_transport([]))
        fleet.live.pop(0)
        with pytest.raises(RequestRejected) as err:
            r.submit(SPEC, deadline_s=5)
        assert err.value.retry_after_s > 0
        assert r.stats()["rejected"] == 1

    def test_route_blackhole_fault_forces_failover(self, tmp_path):
        fleet = _StubFleet([0, 1, 2])
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"route.blackhole": {"times": 1}})
        log = []
        r = FleetRouter(fleet, faults=plan, transport=_ok_transport(log))
        status, _ = r.submit(SPEC, deadline_s=10)
        assert status == 200
        st = r.stats()
        assert st["blackholed"] == 1 and st["failovers"] == 1
        assert plan.shots_fired("route.blackhole") == 1
        # replica was NOT killed: a partition is not a death
        assert fleet.killed == []

    def test_replica_kill_fault_fires_before_forward(self, tmp_path):
        fleet = _StubFleet([0, 1, 2])
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"replica.kill": {"after_requests": 2}})
        seen = []

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            if rid not in fleet.live:
                raise ConnectionError("killed")
            seen.append(rid)
            return 200, {"status": "done", "profile": [[1.0]]}

        r = FleetRouter(fleet, faults=plan, transport=transport)
        for i in range(4):
            status, _ = r.submit(dict(SPEC, seed=i), deadline_s=10)
            assert status == 200
        st = r.stats()
        assert st["kills_fired"] == 1 and len(fleet.killed) == 1
        assert st["routed"] == 4          # every request still completed
        assert st["failovers"] >= 1       # the victim's request re-routed

    def test_deadline_exhaustion_raises_route_failed(self):
        fleet = _StubFleet([0])

        def transport(method, url, body, timeout):
            raise ConnectionError("always down")

        r = FleetRouter(fleet, transport=transport)
        with pytest.raises(RouteFailed):
            r.submit(SPEC, deadline_s=0.3)


# ---------------------------------------------------------------------------
# circuit breakers: gray-failure ejection + half-open recovery
# ---------------------------------------------------------------------------


class _RestartStubFleet(_StubFleet):
    def __init__(self, ids, quorum=1):
        super().__init__(ids, quorum)
        self.restarted = []

    def restart_replica(self, i):
        self.restarted.append(i)


class TestCircuitBreaker:
    def _slow_transport(self, slow_ids, slow_s=0.2, fast_s=0.001):
        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            time.sleep(slow_s if rid in slow_ids else fast_s)
            return 200, {"status": "done", "rid": rid, "profile": [[1.0]]}
        return transport

    def _router(self, fleet, transport, **kw):
        kw.setdefault("breaker_outlier", 3.0)
        kw.setdefault("breaker_min_latency_s", 0.05)
        kw.setdefault("breaker_min_samples", 2)
        kw.setdefault("breaker_reset_s", 0.3)
        return FleetRouter(fleet, transport=transport, **kw)

    def test_latency_outlier_is_ejected_and_handed_to_supervisor(self):
        """An alive-but-slow replica (answers, just 200x slower than its
        peers) must be ejected by the latency breaker — health polling
        cannot see this — and handed to the supervisor for a graceful
        restart when eject_restart is on."""
        fleet = _RestartStubFleet([0, 1])
        slow = {1}
        r = self._router(fleet, self._slow_transport(slow),
                         eject_restart=True)
        for seed in range(16):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        st = r.stats()
        assert st["ejections"] == 1
        assert st["breakers"][1]["state"] == "open"
        assert st["breakers"][1]["reason"] == "latency"
        assert fleet.restarted == [1]
        # while open, the slow replica's keys route to the healthy one:
        # responses keep coming and none are slow
        t0 = time.perf_counter()
        for seed in range(16, 22):
            status, resp = r.submit(dict(SPEC, seed=seed), deadline_s=10)
            assert status == 200
        assert time.perf_counter() - t0 < 0.15   # all fast-path

    def test_half_open_probe_recovers_after_fault_clears(self):
        fleet = _StubFleet([0, 1])
        slow = {1}
        r = self._router(fleet, self._slow_transport(slow))
        for seed in range(16):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        assert r.stats()["breakers"][1]["state"] == "open"
        slow.clear()                       # the gray failure heals
        time.sleep(0.35)                   # past breaker_reset_s
        for seed in range(16, 40):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        st = r.stats()
        assert st["breakers"][1]["state"] == "closed"
        assert st["per_replica"].get(1, 0) > 0   # taking traffic again
        assert st["breakers"][1]["ejections"] == 1  # no flapping

    def test_still_slow_probe_reopens(self):
        """A half-open probe that is STILL slow must re-open the breaker
        (reopen-on-still-sick), not hand the replica its keys back."""
        fleet = _StubFleet([0, 1])
        r = self._router(fleet, self._slow_transport({1}))
        for seed in range(16):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        assert r.stats()["breakers"][1]["state"] == "open"
        time.sleep(0.35)
        for seed in range(16, 32):         # probes stay slow
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        st = r.stats()["breakers"][1]
        assert st["state"] == "open" and st["ejections"] >= 2

    def test_fast_5xx_counts_as_breaker_failure(self):
        """A replica answering every request with a fast
        500 is as sick as one refusing connections — it must open the
        breaker, not be recorded as a near-zero-latency success."""
        fleet = _StubFleet([0, 1])

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            if rid == 1:
                return 500, {"error": "internal"}
            return 200, {"status": "done", "profile": [[1.0]]}

        r = self._router(fleet, transport, breaker_fails=2,
                         breaker_reset_s=60.0)
        statuses = [r.submit(dict(SPEC, seed=s), deadline_s=10)[0]
                    for s in range(24)]
        st = r.stats()["breakers"][1]
        assert st["state"] == "open" and st["reason"] == "errors"
        # once open, the 500s stop reaching clients
        assert 500 not in statuses[-6:]

    def test_backpressure_replies_do_not_poison_the_ewma(self):
        """~Instant 429s from a saturated replica must stay
        out of its latency EWMA — otherwise its healthy peer doing real
        work looks like a latency outlier and gets ejected."""
        fleet = _StubFleet([0, 1])

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            if rid == 1:
                return 429, {"error": "queue full", "retry_after_s": 0.5}
            time.sleep(0.01)          # replica 0 does real work
            return 200, {"status": "done", "profile": [[1.0]]}

        r = self._router(fleet, transport, breaker_outlier=3.0,
                         breaker_min_latency_s=0.001,
                         breaker_min_samples=2)
        for s in range(24):
            r.submit(dict(SPEC, seed=s), deadline_s=10)
        st = r.stats()["breakers"]
        assert st[0]["state"] == "closed"          # NOT ejected
        assert st.get(1, {}).get("samples", 0) == 0  # 429s not sampled

    def test_consecutive_failures_open_breaker(self):
        fleet = _StubFleet([0, 1])
        dead = {1}

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            if rid in dead:
                raise ConnectionError("wedged socket")
            return 200, {"status": "done", "profile": [[1.0]]}

        r = self._router(fleet, transport, breaker_fails=2)
        for seed in range(24):
            status, _ = r.submit(dict(SPEC, seed=seed), deadline_s=10)
            assert status == 200           # failover hides the failures
        st = r.stats()
        assert st["breakers"][1]["state"] == "open"
        assert st["breakers"][1]["reason"] == "errors"
        # once open, no further forwards hit the dead replica: failovers
        # stop accumulating
        before = r.stats()["failovers"]
        for seed in range(24, 30):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        assert r.stats()["failovers"] == before


class TestRouterEdgeCases:
    def test_all_breakers_open_raises_route_failed_with_trace(self):
        """Every live replica behind an open breaker -> RouteFailed with
        the attempt trace and breaker states, promptly — never a hang
        until the deadline."""
        fleet = _StubFleet([0, 1])

        def transport(method, url, body, timeout):
            raise ConnectionError("always down")

        r = FleetRouter(fleet, transport=transport, breaker_fails=1,
                        breaker_reset_s=60.0)
        t0 = time.perf_counter()
        with pytest.raises(RouteFailed) as err:
            r.submit(SPEC, deadline_s=30)
        assert time.perf_counter() - t0 < 5.0
        assert len(err.value.attempts) >= 2        # both replicas tried
        assert "breakers" in str(err.value)

    def test_expired_deadline_rejects_with_zero_transport_calls(self):
        fleet = _StubFleet([0, 1])
        calls = []

        def transport(method, url, body, timeout):
            calls.append(url)
            return 200, {"status": "done", "profile": [[1.0]]}

        r = FleetRouter(fleet, transport=transport)
        with pytest.raises(RouteFailed):
            r.submit(SPEC, deadline_s=-0.5)
        with pytest.raises(RouteFailed):
            r.submit(SPEC, deadline_s=0.0)
        assert calls == []

    def test_unexpected_transport_error_releases_probe_slot(self):
        """An exception OUTSIDE the failover tuple (e.g. a
        truncated-body ValueError from the transport's json parse) must
        not strand the half-open probing flag — the replica would be
        unroutable forever."""
        fleet = _StubFleet([0, 1])
        mode = {"fail": True}

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            if rid == 1 and mode["fail"]:
                raise ConnectionError("down")
            if rid == 1 and mode.get("garble"):
                raise ValueError("truncated body")
            return 200, {"status": "done", "rid": rid, "profile": [[1.0]]}

        r = FleetRouter(fleet, transport=transport, breaker_fails=1,
                        breaker_reset_s=0.1)
        # open replica 1's breaker
        for seed in range(8):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        assert r.stats()["breakers"][1]["state"] == "open"
        mode["fail"] = False
        mode["garble"] = True
        time.sleep(0.15)               # past reset: next hit is a probe
        # drive until a probe routes to replica 1 and garbles
        for seed in range(8, 40):
            try:
                r.submit(dict(SPEC, seed=seed), deadline_s=10)
            except ValueError:
                break
        else:
            pytest.fail("no probe reached the garbling replica")
        # the probe slot is free: once healthy, the replica recovers
        mode["garble"] = False
        time.sleep(0.15)
        for seed in range(40, 64):
            r.submit(dict(SPEC, seed=seed), deadline_s=10)
        st = r.stats()["breakers"][1]
        assert st["state"] == "closed"

    def test_all_replicas_excluded_then_deadline_bounds_the_retry(self):
        """Transport fails everywhere with breakers effectively off: the
        clear-and-retry loop must stay bounded by the deadline and raise
        RouteFailed carrying the per-replica attempt trace."""
        fleet = _StubFleet([0])

        def transport(method, url, body, timeout):
            raise ConnectionError("down")

        r = FleetRouter(fleet, transport=transport, breaker_fails=10**6)
        with pytest.raises(RouteFailed) as err:
            r.submit(SPEC, deadline_s=0.3)
        assert err.value.attempts
        assert "0" in str(err.value.attempts[0][0])


# ---------------------------------------------------------------------------
# deadline-aware shedding + load-proportional Retry-After
# ---------------------------------------------------------------------------


class TestLoadShedding:
    def _stalled_service(self, **kw):
        from psrsigsim_torch.serve import SimulationService

        class NoBatch(SimulationService):
            def _batch_loop(self):   # queue fills, nothing drains
                return

        kw.setdefault("cache_dir", None)
        kw.setdefault("widths", (1,))
        kw.setdefault("device", "cpu")
        return NoBatch(**kw)

    def test_retry_after_hint_monotone_in_queue_depth(self):
        """The Retry-After hint derives from queue
        depth x observed service rate, floored at the static hint —
        strictly monotone (non-decreasing) in depth."""
        svc = self._stalled_service(max_queue=64, retry_after_s=0.5)
        try:
            svc._svc_ewma = 0.2
            hints = [svc._retry_hint(d) for d in range(32)]
            assert all(a <= b for a, b in zip(hints, hints[1:]))
            assert hints[0] == 0.5            # floor at zero depth
            assert hints[-1] == pytest.approx(31 * 0.2)
            # before any observation the static floor applies everywhere
            svc._svc_ewma = 0.0
            assert [svc._retry_hint(d) for d in (0, 8, 64)] == [0.5] * 3
        finally:
            svc.close()

    def test_queue_full_hint_scales_with_load(self):
        svc = self._stalled_service(max_queue=3, retry_after_s=0.5)
        try:
            svc._svc_ewma = 0.4
            for i in range(3):
                rid, st = svc.submit(dict(SPEC, seed=i), deadline_s=60)
                assert st == "queued"
            with pytest.raises(RequestRejected) as err:
                svc.submit(dict(SPEC, seed=99), deadline_s=60)
            assert err.value.retry_after_s == pytest.approx(3 * 0.4)
            assert err.value.retry_after_s > 0.5    # beyond the floor
        finally:
            svc.close()

    def test_unmeetable_deadline_is_shed_at_admission(self):
        svc = self._stalled_service(max_queue=8)
        try:
            svc._svc_ewma = 0.2
            for i in range(4):
                svc.submit(dict(SPEC, seed=i), deadline_s=60)
            # predicted wait 4 * 0.2 = 0.8 s > 0.3 s budget: shed
            with pytest.raises(RequestRejected) as err:
                svc.submit(dict(SPEC, seed=50), deadline_s=0.3)
            assert "unmeetable" in err.value.reason
            assert svc.shed == 1
            # a meetable deadline is admitted at the same depth
            rid, st = svc.submit(dict(SPEC, seed=51), deadline_s=60)
            assert st == "queued"
            # with no evidence (EWMA 0) nothing positive is shed
            svc._svc_ewma = 0.0
            rid, st = svc.submit(dict(SPEC, seed=52), deadline_s=0.01)
            assert st == "queued"
        finally:
            svc.close()


# ---------------------------------------------------------------------------
# cache write-failure cleanup + ENOSPC degradation
# ---------------------------------------------------------------------------


class TestCacheWriteFailure:
    def test_enospc_during_artifact_write_cleans_tmp_and_claim(
            self, tmp_path):
        """An OSError mid-commit must unlink the tmp
        and release the claim BEFORE re-raising — a failed writer never
        wedges the per-hash single-writer claim until claim_timeout_s."""
        d = str(tmp_path / "c")
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"cache.enospc": {"times": 1}})
        # huge claim timeout: if the claim leaked, the re-put below
        # would stall visibly instead of passing
        c = ResultCache(d, faults=plan, claim_timeout_s=3600.0)
        arr = np.ones((2, 4), np.float32)
        with pytest.raises(OSError):
            c.put("aa" * 32, arr)
        assert c.write_errors == 1
        assert not os.listdir(os.path.join(d, "claims"))
        assert not [n for n in os.listdir(os.path.join(d, "results"))
                    if n.endswith(".tmp")]
        # the SAME writer retries immediately — no claim squatting
        t0 = time.perf_counter()
        rec = c.put("aa" * 32, arr)
        assert time.perf_counter() - t0 < 5.0
        assert rec["hash"] == "aa" * 32
        got = c.get("aa" * 32)
        assert got is not None and got.tobytes() == arr.tobytes()
        c.close()

    def test_enospc_during_journal_append_leaves_clean_state(
            self, tmp_path):
        """The journal variant: artifact renamed but unindexed (the same
        benign state a SIGKILL between rename and append leaves) — no
        torn journal, invisible to readers, recommitted cleanly."""
        d = str(tmp_path / "c")
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"cache.enospc": {"times": 1, "at": "journal"}})
        c = ResultCache(d, faults=plan, claim_timeout_s=3600.0)
        arr = np.ones(4, np.float32)
        with pytest.raises(OSError):
            c.put("bb" * 32, arr)
        assert c.get("bb" * 32) is None       # never indexed
        assert not os.listdir(os.path.join(d, "claims"))
        rec = c.put("bb" * 32, arr)           # recommit over the orphan
        assert rec["hash"] == "bb" * 32
        c.close()
        # a fresh verify finds nothing torn
        v = ResultCache(d, verify=True)
        assert v.dropped == 0 and v.get("bb" * 32) is not None
        v.close()

    def test_write_errors_surface_in_stats(self, tmp_path):
        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"cache.enospc": {"times": 2}})
        c = ResultCache(str(tmp_path / "c"), faults=plan)
        for h in ("cc" * 32, "dd" * 32):
            with pytest.raises(OSError):
                c.put(h, np.zeros(2, np.float32))
        assert c.stats()["write_errors"] == 2
        c.close()


# ---------------------------------------------------------------------------
# elastic fleet: autoscaler control loop over stub replicas
# ---------------------------------------------------------------------------


#: a "replica" that speaks the one-line ready protocol then sleeps —
#: real process lifecycle (spawn/SIGTERM/SIGKILL/restart) with no torch
_STUB_REPLICA = ("import json,sys,time;"
                 "print(json.dumps({'ready': True, 'port': 1}));"
                 "sys.stdout.flush(); time.sleep(300)")


def _stub_fleet_cls():
    from psrsigsim_torch.serve import ReplicaFleet

    class StubReplicaFleet(ReplicaFleet):
        """Real fleet machinery over stub replica processes, with the
        health poll answered locally (no sockets)."""

        fake_depth = 0
        poll_error = None

        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

        def _replica_cmd(self, i):
            return [sys.executable, "-c", _STUB_REPLICA]

        def _poll_health(self, url):
            if self.poll_error is not None:
                raise self.poll_error
            return {"ok": True, "queue_depth": self.fake_depth,
                    "max_queue": self.max_queue, "request_p95_s": 0.0}

    return StubReplicaFleet


def _wait_for(cond, timeout=30.0, period=0.05):
    t_end = time.time() + timeout
    while time.time() < t_end:
        if cond():
            return True
        time.sleep(period)
    return False


class TestElasticFleet:
    def test_hysteresis_validation(self, tmp_path):
        from psrsigsim_torch.serve import ReplicaFleet

        with pytest.raises(ValueError):
            ReplicaFleet(1, str(tmp_path), autoscale=True, min_replicas=1,
                         max_replicas=2, scale_up_queue_frac=0.1,
                         scale_down_queue_frac=0.1,
                         device="cpu")   # up must be > down
        with pytest.raises(ValueError):
            ReplicaFleet(1, str(tmp_path), min_replicas=3, max_replicas=2,
                         device="cpu")

    def test_scale_up_then_down_with_lossless_retire(self, tmp_path):
        """The control-loop pin: queue pressure spawns a replica (scale
        event recorded, membership grows), idleness retires the NEWEST
        one via SIGTERM after the longer down-cooldown, and the retiree
        leaves routing before its drain signal."""
        Fleet = _stub_fleet_cls()
        fleet = Fleet(1, str(tmp_path / "c"), quorum=1, autoscale=True,
                      min_replicas=1, max_replicas=2,
                      scale_up_queue_frac=0.2, scale_down_queue_frac=0.05,
                      scale_interval_s=0.05, scale_up_cooldown_s=0.05,
                      scale_down_cooldown_s=0.2, health_interval_s=0.05,
                      ready_timeout_s=30.0)
        fleet.start()
        try:
            assert _wait_for(lambda: fleet.healthy_count() == 1)
            Fleet.fake_depth = fleet.max_queue        # saturated queues
            assert _wait_for(lambda: fleet.scale_events), fleet.health()
            assert [e["action"] for e in fleet.scale_events] == ["up"]
            assert _wait_for(lambda: fleet.healthy_count() == 2)
            new_id = max(i for i, _ in fleet.endpoints())
            Fleet.fake_depth = 0                      # idle
            assert _wait_for(lambda: fleet.active_count() == 1), \
                fleet.health()
            ev = fleet.scale_events[-1]
            assert ev["action"] == "down" and ev["replica"] == new_id
            # the retiree is out of routing immediately
            assert new_id not in [i for i, _ in fleet.endpoints()]
            h = fleet.health()
            assert h["autoscale"]["retired"] == [new_id]
            # and never drops below min_replicas
            assert _wait_for(lambda: fleet.active_count() == 1,
                             timeout=1.0) and fleet.active_count() == 1
        finally:
            fleet.drain()

    def test_bounded_by_max_replicas(self, tmp_path):
        Fleet = _stub_fleet_cls()
        fleet = Fleet(1, str(tmp_path / "c"), quorum=1, autoscale=True,
                      min_replicas=1, max_replicas=2,
                      scale_up_queue_frac=0.2, scale_down_queue_frac=0.05,
                      scale_interval_s=0.05, scale_up_cooldown_s=0.05,
                      scale_down_cooldown_s=60.0, health_interval_s=0.05,
                      ready_timeout_s=30.0)
        fleet.start()
        try:
            Fleet.fake_depth = fleet.max_queue
            assert _wait_for(lambda: fleet.active_count() == 2)
            time.sleep(0.5)            # sustained overload at the cap
            assert fleet.active_count() == 2
        finally:
            fleet.drain()

    def test_health_poll_timeout_sigkills_into_restart(self, tmp_path):
        """ReplicaFleet._health_loop: a replica
        that stops answering /healthz (alive process, wedged listener)
        is SIGKILLed after health_fail_after consecutive failures and
        restarted by its supervisor."""
        import urllib.error

        Fleet = _stub_fleet_cls()
        # deep restart budget: the poll keeps failing until the test
        # clears it, and a slow CI box must not exhaust the policy and
        # mark the replica failed before that
        fleet = Fleet(1, str(tmp_path / "c"), quorum=1,
                      health_interval_s=0.05, health_fail_after=3,
                      ready_timeout_s=30.0,
                      policy=RetryPolicy(max_attempts=100,
                                         base_delay=0.05, max_delay=0.2))
        fleet.start()
        try:
            assert _wait_for(lambda: fleet.healthy_count() == 1)
            pid1 = fleet._sups[0].pid
            Fleet.poll_error = urllib.error.URLError("wedged")
            # 3 failed polls -> SIGKILL -> supervisor respawn
            assert _wait_for(lambda: fleet._sups[0].restarts >= 1), \
                fleet.health()
            Fleet.poll_error = None
            assert _wait_for(
                lambda: fleet.healthy_count() == 1
                and fleet._sups[0].pid not in (None, pid1))
        finally:
            fleet.drain()

    def test_scale_down_never_retires_below_quorum(self, tmp_path):
        """An idle autoscaled fleet with quorum above
        min_replicas must stop retiring AT the quorum — below it the
        router rejects everything and the queue signal that would
        trigger recovery can never form."""
        Fleet = _stub_fleet_cls()
        fleet = Fleet(3, str(tmp_path / "c"), quorum=2, autoscale=True,
                      min_replicas=1, max_replicas=3,
                      scale_up_queue_frac=0.5, scale_down_queue_frac=0.1,
                      scale_interval_s=0.05, scale_up_cooldown_s=0.05,
                      scale_down_cooldown_s=0.1, health_interval_s=0.05,
                      ready_timeout_s=30.0)
        fleet.start()
        try:
            assert _wait_for(lambda: fleet.healthy_count() == 3)
            Fleet.fake_depth = 0                      # idle forever
            assert _wait_for(lambda: fleet.active_count() == 2)
            time.sleep(0.6)    # several down-cooldowns worth of idle
            assert fleet.active_count() == 2          # stopped AT quorum
            assert fleet.has_quorum()
        finally:
            fleet.drain()

    def test_autoscale_default_quorum_tracks_min_replicas(self, tmp_path):
        from psrsigsim_torch.serve import ReplicaFleet

        f = ReplicaFleet(4, str(tmp_path / "a"), autoscale=True,
                         min_replicas=2, max_replicas=8, device="cpu")
        assert f.quorum == 2           # majority of min, not of initial
        f2 = ReplicaFleet(4, str(tmp_path / "b"), device="cpu")
        assert f2.quorum == 3          # fixed fleet: majority of size

    def test_dead_replica_contributes_no_capacity(self, tmp_path):
        """A crashed member in restart backoff must not
        count as idle capacity — that would suppress the scale-up
        signal exactly during a partial outage."""
        Fleet = _stub_fleet_cls()
        fleet = Fleet(2, str(tmp_path / "c"), quorum=1, max_queue=10,
                      health_interval_s=0.05, ready_timeout_s=30.0,
                      policy=RetryPolicy(max_attempts=3, base_delay=5.0,
                                         max_delay=10.0))
        fleet.start()
        try:
            Fleet.fake_depth = 4
            # wait for real health samples (capacity alone also counts
            # booting members), then kill one replica
            assert _wait_for(
                lambda: fleet.load_signal()["queue_depth"] == 8)
            fleet._sups[1].kill()      # dies; restart is 5 s away
            assert _wait_for(lambda: not fleet._sups[1].alive())
            sig = fleet.load_signal()
            assert sig["capacity"] == 10     # only the live replica
            assert sig["queue_frac"] >= 0.4  # outage INCREASES the frac
        finally:
            fleet.drain()

    def test_failed_member_is_pruned_from_active(self, tmp_path):
        """A member whose supervisor exhausted its restart
        budget must be evicted from the active set, or it would hold an
        `active < max_replicas` slot forever and cap scale-up."""
        Fleet = _stub_fleet_cls()
        fleet = Fleet(2, str(tmp_path / "c"), quorum=1, autoscale=True,
                      min_replicas=1, max_replicas=2,
                      scale_up_queue_frac=0.5, scale_down_queue_frac=0.1,
                      scale_interval_s=0.05, scale_up_cooldown_s=60.0,
                      scale_down_cooldown_s=60.0, health_interval_s=0.05,
                      ready_timeout_s=30.0)
        fleet.start()
        try:
            assert _wait_for(lambda: fleet.healthy_count() == 2)
            sup = fleet._sups[1]
            sup.stop()                 # simulate exhaustion terminally
            sup.failed = True
            assert _wait_for(lambda: fleet.active_count() == 1), \
                fleet.health()
            ev = fleet.scale_events[-1]
            assert ev["action"] == "failed" and ev["replica"] == 1
            assert fleet.health()["autoscale"]["retired"] == [1]
        finally:
            fleet.drain()

    def test_load_signal_aggregates_health(self, tmp_path):
        Fleet = _stub_fleet_cls()
        fleet = Fleet(2, str(tmp_path / "c"), quorum=1, max_queue=10,
                      health_interval_s=0.05, ready_timeout_s=30.0)
        fleet.start()
        try:
            Fleet.fake_depth = 5
            assert _wait_for(
                lambda: fleet.load_signal()["queue_frac"] == 0.5), \
                fleet.load_signal()
            sig = fleet.load_signal()
            assert sig["capacity"] == 20 and sig["queue_depth"] == 10
            assert sig["active"] == 2
        finally:
            fleet.drain()
            Fleet.fake_depth = 0
