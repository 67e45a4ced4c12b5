"""The port's sweep farm (``repro_torch.serve``) on the CPU.

Every case of ``tests/test_serve.py`` on the port (durable journal,
typed admission, coalescing, the exactly-once farm), with the port's own
rules: a mesh job is admitted on any number of devices (several shards
share one), a fault after an in-place half-sweep write fails the job
instead of retrying it, the runner pool refills its planes in place, and
with no card and no device named the farm raises.  Against the JAX
package: the same submissions give the same job ids, batch ids, start
groupings and digests; each package reads the other's journal (torn and
bit-rotted tails included) and resumes the other's farm directory left
in the middle of a batch.  The crash drill runs through the CLI in
subprocesses.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import repro.api as japi
import repro.serve as jserve
import repro.serve.journal as jjournal
import repro_torch.serve.journal as pjournal
import repro_torch.telemetry as tel
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec,
                             RunSpec, SweepSpec)
from repro_torch.api.session import Session
from repro_torch.api.spec import MAX_BATCH_SEED
from repro_torch.core.engine import MultispinEngine
from repro_torch.resilience import TransientDispatchError, degrade, faults
from repro_torch.serve import (AdmissionError, DrainingError, Journal,
                               JournalError, QueueFullError, SweepFarm)
from repro_torch.serve import server as serve_server
from repro_torch.serve.journal import JOURNAL_NAME, job_table, replay
from repro_torch.serve.scheduler import (Job, coalesce_key, parse_envelope,
                                         plan_batches)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    """Faults and demotions are process-global by design; tests must
    not leak them into each other."""
    faults.clear()
    degrade.reset_demotions()
    yield
    faults.clear()
    degrade.reset_demotions()


@pytest.fixture
def nosleep(monkeypatch):
    """Retry without wall-clock backoff."""
    monkeypatch.setattr(degrade, "DEFAULT_POLICY",
                        degrade.RetryPolicy(sleep=lambda d: None))


def _spec(engine="multispin", n=16, m=32, temperature=2.1, seed=7,
          **kw):
    return RunSpec(lattice=LatticeSpec(n, m),
                   engine=EngineSpec(engine),
                   temperature=temperature, seed=seed, **kw)


def _job(jid, spec, sweeps=32, timeout_s=None):
    return Job(id=jid, spec=spec, sweeps=sweeps, timeout_s=timeout_s,
               submitted_t=0.0)


def _direct_digest(spec, sweeps):
    s = Session.open(spec, "cpu")
    s.run(sweeps)
    return s.state_digest()


# ---------------------------------------------------------------------------
# journal: durability framing + torn-write recovery
# ---------------------------------------------------------------------------

_RECORDS = [{"kind": "submit", "job": "j1", "x": 1},
            {"kind": "start", "batch": "b1", "jobs": ["j1"]},
            {"kind": "done", "job": "j1", "status": "completed"}]


def _write_journal(path, records=_RECORDS, journal=Journal):
    with journal(str(path)) as j:
        for r in records:
            j.append(r)
    return str(path)


def test_journal_roundtrip(tmp_path):
    path = _write_journal(tmp_path / JOURNAL_NAME)
    with Journal(path) as j:
        assert j.records == _RECORDS
        assert j.recovered_tail is None
    assert list(replay(path)) == _RECORDS


def test_journal_append_validation(tmp_path):
    with Journal(str(tmp_path / JOURNAL_NAME)) as j:
        with pytest.raises(JournalError, match="dicts with a 'kind'"):
            j.append(["not", "a", "dict"])
        with pytest.raises(JournalError, match="dicts with a 'kind'"):
            j.append({"job": "j1"})


def test_journal_torn_tail_recovers_to_last_whole_record(tmp_path):
    path = _write_journal(tmp_path / JOURNAL_NAME)
    size = os.path.getsize(path)
    faults.truncate_file(path, size - 7)  # tear the final record
    with Journal(path) as j:
        assert j.records == _RECORDS[:2]
        assert j.recovered_tail is not None
        assert os.path.exists(j.recovered_tail)
        # the torn bytes are quarantined, not destroyed
        with open(j.recovered_tail, "rb") as f:
            assert b"done" in f.read()
        j.append(_RECORDS[2])  # appending after recovery is normal
    with Journal(path) as j:
        assert j.records == _RECORDS
        assert j.recovered_tail is None


def test_journal_bitrot_in_tail_is_quarantined(tmp_path):
    path = _write_journal(tmp_path / JOURNAL_NAME)
    size = os.path.getsize(path)
    faults.flip_byte_in_file(path, offset=size - 5)
    with Journal(path) as j:
        assert j.records == _RECORDS[:2]
        assert j.recovered_tail is not None


def test_journal_midfile_corruption_raises(tmp_path):
    path = _write_journal(tmp_path / JOURNAL_NAME)
    # damage the FIRST record while valid ones follow: an append-only
    # fsync'd writer cannot produce this, so replay must refuse to
    # silently drop the acknowledged tail
    faults.flip_byte_in_file(path, offset=12)
    with pytest.raises(JournalError, match="AFTER damaged"):
        Journal(path)


def test_job_table_enforces_exactly_once():
    sub = {"kind": "submit", "job": "j1"}
    done = {"kind": "done", "job": "j1", "status": "completed"}
    jobs, dones = job_table([sub, done])
    assert list(jobs) == ["j1"] and dones["j1"] is done
    with pytest.raises(JournalError, match="duplicate submit"):
        job_table([sub, sub])
    with pytest.raises(JournalError, match="unknown job"):
        job_table([done])
    with pytest.raises(JournalError, match="exactly-once"):
        job_table([sub, done, done])


#: the journal modules of the two packages
_PACKAGES = {"jax": jjournal, "port": pjournal}


@pytest.mark.parametrize("damage", ["none", "torn", "bitrot"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_journal_written_by_one_package_replays_in_the_other(
        tmp_path, writer, reader, damage):
    """The same bytes: a journal of either package, its tail torn or
    bit-rotted, replays in the other to the same records and job table,
    and the reader's appends read back in the writer's package."""
    records = _RECORDS + [{"kind": "submit", "job": "j2",
                           "spec": _spec().to_dict(), "t": 1.5}]
    path = _write_journal(tmp_path / JOURNAL_NAME, records,
                          _PACKAGES[writer].Journal)
    with open(path, "rb") as f:
        assert f.read().count(b"\n") == len(records)
    size = os.path.getsize(path)
    if damage == "torn":
        faults.truncate_file(path, size - 7)
    elif damage == "bitrot":
        faults.flip_byte_in_file(path, offset=size - 5)
    want = records if damage == "none" else records[:-1]
    r = _PACKAGES[reader]
    with r.Journal(path) as j:
        assert j.records == want
        assert (j.recovered_tail is None) == (damage == "none")
        assert r.job_table(j.records) == \
            _PACKAGES[writer].job_table(want)
        j.append({"kind": "done", "job": "j2", "status": "failed"})
    back = list(_PACKAGES[writer].replay(path))
    assert back[:len(want)] == want and back[-1]["job"] == "j2"


# ---------------------------------------------------------------------------
# admission: every malformation is a typed reject, never a crash
# ---------------------------------------------------------------------------

def test_parse_envelope_accepts_envelope_and_bare_spec():
    spec = _spec()
    got, sweeps, timeout = parse_envelope(
        {"spec": spec.to_dict(), "sweeps": 64, "timeout_s": 5})
    assert got.to_dict() == spec.to_dict()
    assert sweeps == 64 and timeout == 5.0
    bare = _spec(sweep=SweepSpec(thermalize=8, n_measure=4))
    got, sweeps, timeout = parse_envelope(bare.to_dict())
    assert sweeps == bare.sweep.total_sweeps and timeout is None


@pytest.mark.parametrize("doc,match", [
    ("not a dict", "must be a JSON object"),
    ({"spec": {}, "swweeps": 3}, "unknown key"),
    ({"spec": {"bogus": 1}, "sweeps": 3}, "bad RunSpec"),
    ({"spec": _spec().to_dict()}, "no sweep target"),
    ({"spec": _spec().to_dict(), "sweeps": 0}, "positive integer"),
    ({"spec": _spec().to_dict(), "sweeps": True}, "positive integer"),
    ({"spec": _spec().to_dict(), "sweeps": 4, "timeout_s": -1},
     "positive number"),
])
def test_parse_envelope_rejects_typed(doc, match):
    with pytest.raises(AdmissionError, match=match):
        parse_envelope(doc)


# ---------------------------------------------------------------------------
# coalescing: deterministic grouping, bit-exactness preconditions
# ---------------------------------------------------------------------------

def test_coalesce_key_preconditions():
    assert coalesce_key(_job("j1", _spec())) is not None
    # key-based engines' digests depend on the chunk grid: never fuse
    assert coalesce_key(_job("j2", _spec(engine="basic"))) is None
    # the ensemble bit-exactness contract bounds member seeds
    assert coalesce_key(
        _job("j3", _spec(seed=MAX_BATCH_SEED))) is None
    assert coalesce_key(_job("j4", _spec(
        batch=BatchSpec(temperatures=(2.0, 2.2))))) is None
    # the sweep target is part of the key: members must stop together
    a = coalesce_key(_job("j5", _spec(), sweeps=32))
    b = coalesce_key(_job("j6", _spec(), sweeps=64))
    assert a is not None and b is not None and a != b


def test_plan_batches_groups_chunks_and_orders():
    co = [_job(f"j{i}", _spec(temperature=2.0 + 0.1 * i, seed=i))
          for i in range(3)]
    solo = _job("j9", _spec(engine="basic"))
    batches = plan_batches([co[0], co[1], solo, co[2]], max_batch=2)
    assert [[j.id for j in b.jobs] for b in batches] \
        == [["j0", "j1"], ["j2"], ["j9"]]
    assert [b.coalesced for b in batches] == [True, True, False]
    fused = batches[0].spec()
    assert fused.mode == "ensemble"
    assert fused.batch.temperatures == (2.0, 2.1)
    assert fused.batch.seeds == (0, 1)


def test_plan_batches_is_deterministic():
    jobs = [_job(f"j{i}", _spec(seed=i)) for i in range(4)]
    a = plan_batches(jobs, max_batch=8)
    b = plan_batches(list(jobs), max_batch=8)
    assert [x.id for x in a] == [y.id for y in b]
    # ids hash (key, member ids): a different grouping is a new batch
    c = plan_batches(jobs[:3], max_batch=8)
    assert c[0].id != a[0].id
    with pytest.raises(ValueError, match="max_batch"):
        plan_batches(jobs, max_batch=0)


# ---------------------------------------------------------------------------
# the farm: coalesced dispatch is digest-preserving and exactly-once
# ---------------------------------------------------------------------------

SWEEPS = 32


def _farm(tmp_path, **kw):
    kw.setdefault("chunk", SWEEPS)  # one dispatch per batch
    return SweepFarm(str(tmp_path / "farm"), device="cpu", **kw)


def _submit(farm, spec, sweeps=SWEEPS, **extra):
    return farm.submit({"spec": spec.to_dict(), "sweeps": sweeps,
                        **extra})


def test_farm_coalesces_and_preserves_digests(tmp_path):
    specs = [_spec(temperature=2.0 + 0.1 * i, seed=20 + i)
             for i in range(3)]
    refs = [_direct_digest(s, SWEEPS) for s in specs]
    farm = _farm(tmp_path)
    jids = [_submit(farm, s) for s in specs]
    before = tel.DISPATCHES.value
    assert farm.run_until_idle() == 1  # one fused batch
    assert tel.DISPATCHES.value - before == 1  # one dispatch
    for jid, want in zip(jids, refs):
        job = farm.job(jid)
        assert job["status"] == "completed"
        assert job["digest"] == want
        assert job["summary"]["coalesced"] == 3
        # the result file is the queryable artifact
        with open(os.path.join(farm.results_dir,
                               f"{jid}.json")) as f:
            assert json.load(f)["digest"] == want
    assert farm.idle
    farm.close()


def test_farm_keeps_incompatible_jobs_apart(tmp_path):
    farm = _farm(tmp_path)
    _submit(farm, _spec(seed=1))
    _submit(farm, _spec(engine="basic", seed=2))  # key-based: solo
    assert farm.run_until_idle() == 2
    assert all(j.terminal for j in farm.jobs.values())
    farm.close()


def test_farm_restart_is_exactly_once(tmp_path):
    specs = [_spec(temperature=2.0 + 0.1 * i, seed=30 + i)
             for i in range(2)]
    farm = _farm(tmp_path)
    jids = [_submit(farm, s) for s in specs]
    farm.run_until_idle()
    digests = [farm.job(j)["digest"] for j in jids]
    farm.close()
    # restart: replay must restore the terminal states and re-run
    # NOTHING (dispatches delta 0)
    before = tel.DISPATCHES.value
    farm2 = _farm(tmp_path)
    assert farm2.run_until_idle() == 0
    assert tel.DISPATCHES.value - before == 0
    assert [farm2.job(j)["digest"] for j in jids] == digests
    # the only path to a terminal state refuses a second done record
    with pytest.raises(JournalError, match="exactly-once"):
        farm2._finish(farm2.jobs[jids[0]], "completed")
    farm2.close()


def test_farm_runner_pool_reuses_runner(tmp_path):
    farm = _farm(tmp_path)
    for i in range(2):
        _submit(farm, _spec(temperature=2.0 + 0.1 * i, seed=40 + i))
    farm.run_until_idle()
    assert farm.status()["runner_pool"] == 1
    # a second wave of the same dispatch shape rebinds the pooled
    # runner: one dispatch, digests still bit-exact
    spec2 = [_spec(temperature=2.3 + 0.1 * i, seed=50 + i)
             for i in range(2)]
    hits = serve_server.CACHE_HITS.value
    misses = serve_server.CACHE_MISSES.value
    before = tel.DISPATCHES.value
    jids = [_submit(farm, s) for s in spec2]
    farm.run_until_idle()
    assert serve_server.CACHE_HITS.value - hits == 1
    assert serve_server.CACHE_MISSES.value == misses
    assert tel.DISPATCHES.value - before == 1
    for jid, s in zip(jids, spec2):
        assert farm.job(jid)["digest"] == _direct_digest(s, SWEEPS)
    farm.close()


def test_farm_backpressure_and_drain_rejects(tmp_path):
    farm = _farm(tmp_path, max_queue=1)
    rejected = serve_server.REJECTED.value
    with pytest.raises(AdmissionError):
        farm.submit({"spec": {"bogus": 1}, "sweeps": 4})
    _submit(farm, _spec())
    with pytest.raises(QueueFullError, match="capacity"):
        _submit(farm, _spec(seed=8))
    farm.request_drain()
    assert farm.status()["draining"]
    with pytest.raises(DrainingError, match="draining"):
        _submit(farm, _spec(seed=9))
    assert serve_server.REJECTED.value - rejected == 3
    farm.close()


def test_farm_deadline_fails_queued_job_without_running_it(tmp_path):
    farm = _farm(tmp_path)
    jid = _submit(farm, _spec(), timeout_s=1e-6)
    time.sleep(0.01)
    before = tel.DISPATCHES.value
    assert farm.run_until_idle() == 0  # expired before dispatch
    assert tel.DISPATCHES.value - before == 0
    job = farm.job(jid)
    assert job["status"] == "failed"
    assert "deadline exceeded" in job["error"]
    farm.close()


def test_farm_transient_fault_retries_bit_exact(tmp_path, nosleep):
    """On the k-sweep tier, which works out of place: the injected
    transient fault is retried and the digest is the direct run's."""
    spec = _spec(seed=61)
    assert Session.open(spec, "cpu").engine.resident_plan is not None
    want = _direct_digest(spec, SWEEPS)
    farm = _farm(tmp_path)
    retries = tel.REGISTRY.counter("resilience.retry").value
    with faults.injected(faults.FaultPlan(transient_dispatches=1)):
        jid = _submit(farm, spec)
        farm.run_until_idle()
    assert tel.REGISTRY.counter("resilience.retry").value > retries
    job = farm.job(jid)
    assert job["status"] == "completed" and job["digest"] == want
    farm.close()


def test_farm_fault_after_in_place_write_fails_the_job(
        tmp_path, nosleep, monkeypatch):
    """On the per-half-sweep tier, whose launches write the planes in
    place: a transient failure after the first write is not retried (the
    state has moved); it is the job's ``failed`` result, and the farm
    keeps serving."""
    spec = _spec(seed=64)
    degrade.demote("multispin", 16, 32, "the half-sweep tier, by hand")
    assert Session.open(spec, "cpu").engine.resident_plan is None
    real = MultispinEngine.color_update

    def once(self, *args, **kwargs):
        real(self, *args, **kwargs)
        raise TransientDispatchError("after the first in-place launch")

    monkeypatch.setattr(MultispinEngine, "color_update", once)
    farm = _farm(tmp_path)
    retries = tel.REGISTRY.counter("resilience.retry").value
    jid = _submit(farm, spec)
    farm.run_until_idle()
    job = farm.job(jid)
    assert job["status"] == "failed"
    assert TransientDispatchError.__name__ in job["error"]
    assert tel.REGISTRY.counter("resilience.retry").value == retries
    monkeypatch.setattr(MultispinEngine, "color_update", real)
    jid2 = _submit(farm, _spec(seed=65))
    farm.run_until_idle()
    job2 = farm.job(jid2)
    assert job2["status"] == "completed"
    assert job2["digest"] == _direct_digest(_spec(seed=65), SWEEPS)
    farm.close()


def test_farm_job_failure_is_contained(tmp_path, nosleep):
    farm = _farm(tmp_path)
    # enough injected faults to exhaust the bounded retry budget: the
    # job fails, the farm survives and keeps serving
    with faults.injected(faults.FaultPlan(transient_dispatches=100)):
        jid = _submit(farm, _spec(seed=62))
        farm.run_until_idle()
    job = farm.job(jid)
    assert job["status"] == "failed"
    assert TransientDispatchError.__name__ in job["error"]
    jid2 = _submit(farm, _spec(seed=63))
    farm.run_until_idle()
    assert farm.job(jid2)["status"] == "completed"
    farm.close()


def test_farm_recovers_from_torn_journal(tmp_path):
    farm = _farm(tmp_path)
    jid = _submit(farm, _spec(seed=64))
    farm.close()
    path = os.path.join(farm.dir, JOURNAL_NAME)
    size = os.path.getsize(path)
    with open(path, "ab") as f:  # a submit append the crash tore
        f.write(b"deadbeef {\"kind\": \"sub")
    farm2 = _farm(tmp_path)
    assert list(farm2.jobs) == [jid]  # the acked job survived
    assert farm2.jobs[jid].status == "queued"
    assert os.path.getsize(path) == size
    farm2.run_until_idle()
    assert farm2.job(jid)["status"] == "completed"
    farm2.close()


def test_farm_needs_a_card_or_a_device(tmp_path, monkeypatch):
    """No device named and no card: the farm and ``python -m repro_torch
    serve`` raise before they touch the directory; nothing moves to the
    CPU on its own."""
    from repro_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "farm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepFarm(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", d, "--drain-on-idle"])
    assert not os.path.exists(d)


# ---------------------------------------------------------------------------
# the session primitives the farm's bit-exactness rests on
# ---------------------------------------------------------------------------

def test_state_digest_member_matches_single_runs():
    temps, seeds = (2.0, 2.4), (3, 5)
    ens = Session.open(_spec(batch=BatchSpec(temperatures=temps,
                                             seeds=seeds)), "cpu")
    ens.run(SWEEPS)
    for i, (t, s) in enumerate(zip(temps, seeds)):
        want = _direct_digest(_spec(temperature=t, seed=s), SWEEPS)
        assert ens.state_digest(member=i) == want
    with pytest.raises(ValueError, match="member"):
        ens.state_digest(member=7)
    single = Session.open(_spec(), "cpu")
    with pytest.raises(ValueError, match="member"):
        single.state_digest(member=0)


def test_rebind_validates_shape_and_is_bit_exact():
    ens = Session.open(_spec(batch=BatchSpec(temperatures=(2.0, 2.2),
                                             seeds=(1, 2))), "cpu")
    runner = ens._runner
    with pytest.raises(ValueError, match="ensemble"):
        runner.rebind(_spec())
    with pytest.raises(ValueError):  # batch size is part of the shape
        runner.rebind(_spec(batch=BatchSpec(
            temperatures=(2.0, 2.2, 2.4), seeds=(1, 2, 3))))
    with pytest.raises(ValueError):  # so is the lattice
        runner.rebind(_spec(n=32, m=32, batch=BatchSpec(
            temperatures=(2.0, 2.2), seeds=(1, 2))))
    ens.run(3)
    # a shape-compatible rebind refills the planes the runner holds and
    # replays the new members bit-exactly
    spec2 = _spec(batch=BatchSpec(temperatures=(2.1, 2.5),
                                  seeds=(8, 9)))
    held = [p.data_ptr() for p in runner.state]
    runner.rebind(spec2)
    assert [p.data_ptr() for p in runner.state] == held
    assert runner.step_count == 0
    rebound = Session(spec2, runner)
    rebound.run(SWEEPS)
    fresh = Session.open(spec2, "cpu")
    fresh.run(SWEEPS)
    assert rebound.state_digest() == fresh.state_digest()


# ---------------------------------------------------------------------------
# MeshSpec submissions: solo execution on any number of devices
# ---------------------------------------------------------------------------

def test_farm_mesh_job_runs_solo_bit_exact(tmp_path):
    spec = _spec(engine="stencil_pallas", n=32, m=32,
                 mesh=MeshSpec(shape=(1, 1)))
    want = _direct_digest(spec, SWEEPS)
    farm = _farm(tmp_path)
    jid = _submit(farm, spec)
    _submit(farm, _spec(seed=40))      # a coalescible job alongside
    assert coalesce_key(farm.jobs[jid]) is None  # mesh -> never fused
    assert farm.run_until_idle() == 2  # two batches: mesh job ran solo
    job = farm.job(jid)
    assert job["status"] == "completed"
    assert job["digest"] == want       # sharded digest == direct run
    farm.close()


def test_farm_admits_a_mesh_larger_than_the_devices(tmp_path):
    """The JAX farm refuses a (2, 4) mesh on fewer than 8 devices; the
    port's puts its 8 shards on the one device, and the job's digest is
    the single-mode run's (ROADMAP Queue 3)."""
    spec = _spec(engine="stencil_pallas", n=32, m=32,
                 mesh=MeshSpec(shape=(2, 4)))
    single = _spec(engine="stencil_pallas", n=32, m=32)
    farm = _farm(tmp_path)
    jid = _submit(farm, spec)
    ok = _submit(farm, _spec(seed=50))
    assert farm.run_until_idle() == 2
    assert farm.job(jid)["status"] == "completed"
    assert farm.job(jid)["digest"] == _direct_digest(single, SWEEPS)
    assert farm.job(ok)["status"] == "completed"
    farm.close()
    jfarm = jserve.SweepFarm(str(tmp_path / "jax"), chunk=SWEEPS)
    with pytest.raises(jserve.AdmissionError, match="devices"):
        jfarm.submit({"spec": spec.to_dict(), "sweeps": SWEEPS})
    jfarm.close()


# ---------------------------------------------------------------------------
# against the JAX package: the same farm, either package's directory
# ---------------------------------------------------------------------------

#: submissions whose fresh state is equal in both packages (an ordered
#: start) at temperatures whose tables agree (ROADMAP Queue 3): three
#: coalescible multispin jobs, a fourth split off by max_batch, a
#: basic_philox job, one with a seed of 2^33 (solo), one on a mesh
def _parity_docs(api):
    def spec(engine, n, m, t, seed, **kw):
        return api.RunSpec(lattice=api.LatticeSpec(n, m, init_p_up=1.0),
                           engine=api.EngineSpec(engine), temperature=t,
                           seed=seed, **kw)
    specs = [spec("multispin", 16, 32, t, 20 + i)
             for i, t in enumerate((2.0, 2.2, 2.5, 2.3))]
    specs += [spec("basic_philox", 16, 16, 2.2, 5),
              spec("multispin", 16, 32, 2.2, 2 ** 33),
              spec("basic_philox", 16, 16, 2.0, 6,
                   mesh=api.MeshSpec((1, 1), ("data", "model")))]
    return [{"spec": s.to_dict(), "sweeps": 12} for s in specs]


def _starts(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records
            if r["kind"] == "start"]


def test_farm_equals_the_jax_farm(tmp_path):
    jfarm = jserve.SweepFarm(str(tmp_path / "jax"), chunk=4, max_batch=3)
    jids = [jfarm.submit(d) for d in _parity_docs(japi)]
    jfarm.run_until_idle()
    farm = SweepFarm(str(tmp_path / "port"), chunk=4, max_batch=3,
                     device="cpu")
    ids = [farm.submit(d) for d in _parity_docs(japi)]
    farm.run_until_idle()
    assert ids == jids
    assert _starts(farm.journal.records) == _starts(jfarm.journal.records)
    assert len(_starts(farm.journal.records)) == 5
    for jid in ids:
        mine, theirs = farm.job(jid), jfarm.job(jid)
        assert mine["status"] == theirs["status"] == "completed"
        assert mine["digest"] == theirs["digest"]
    farm.close()
    jfarm.close()


def _leave_mid_batch(farm):
    """Drive ``farm`` (either package's) until its first batch has
    checkpointed its first chunk, then drain: the batch stays queued
    with a step in its directory, and the server's exit code is 3."""
    def hook(sup):
        farm.request_drain()
        type(farm)._on_chunk(farm, sup)

    farm._on_chunk = hook
    assert farm.serve_forever(poll=0.01) == 3
    starts = _starts(farm.journal.records)
    assert len(starts) == 1 and not any(
        r["kind"] == "done" for r in farm.journal.records)
    steps = os.listdir(os.path.join(farm.batches_dir, starts[0]["batch"]))
    assert [int(x[len("step_"):]) for x in steps] == [4], steps
    farm.close()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_farm_directory_resumes_in_the_other_package(tmp_path, first):
    """A farm directory one package left in the middle of a coalesced
    batch: the other package's farm resumes the batch from its
    checkpoint (``resilience.resume``) and every job ends with the
    digest of a direct run."""
    d = str(tmp_path / "farm")
    docs = _parity_docs(japi)[:2] + _parity_docs(japi)[4:5]
    kw = dict(chunk=4, ckpt_every_sweeps=4, max_batch=8)
    if first == "jax":
        farm = jserve.SweepFarm(d, **kw)
    else:
        farm = SweepFarm(d, device="cpu", **kw)
    jids = [farm.submit(doc) for doc in docs]
    _leave_mid_batch(farm)
    if first == "jax":
        resumes = tel.REGISTRY.counter("resilience.resume")
        before = resumes.value
        farm = SweepFarm(d, device="cpu", **kw)
    else:
        import repro.telemetry as jtel
        resumes = jtel.REGISTRY.counter("resilience.resume")
        before = resumes.value
        farm = jserve.SweepFarm(d, **kw)
    assert farm.run_until_idle() == 2
    assert resumes.value - before == 1
    for jid, doc in zip(jids, docs):
        job = farm.job(jid)
        assert job["status"] == "completed"
        assert job["digest"] == _direct_digest(
            RunSpec.from_dict(doc["spec"]), doc["sweeps"])
    _, dones = job_table(replay(os.path.join(d, JOURNAL_NAME)))
    assert sorted(dones) == sorted(jids)
    farm.close()


# ---------------------------------------------------------------------------
# the crash drill, through the CLI in subprocesses
# ---------------------------------------------------------------------------

def test_concurrent_first_builds_never_expose_a_partial_library(
        tmp_path, monkeypatch):
    """A restarted server is a new process that loads the library an
    earlier one built; where two processes build one source at once,
    each compiles to a name of its own and renames it into place, so the
    library a reader finds is always whole, and no temporary is left."""
    import threading
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(b'a' * 4096)\n    f.flush()\n    time.sleep(0.3)\n"
        "    f.write(b'b' * 4096)\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    build_dir = tmp_path / "build"
    target = _build._target("k", csrc, build_dir)
    seen, building = [], [True]

    def poll():
        while building[0]:
            if target.exists():
                seen.append(target.read_bytes())
            time.sleep(0.01)

    builders = [threading.Thread(target=_build.build,
                                 args=(["k"], csrc, build_dir))
                for _ in range(2)]
    reader = threading.Thread(target=poll)
    reader.start()
    for t in builders:
        t.start()
    for t in builders:
        t.join(timeout=60)
    building[0] = False
    reader.join(timeout=60)
    assert not any(t.is_alive() for t in builders + [reader])
    whole = b"a" * 4096 + b"b" * 4096
    assert target.read_bytes() == whole
    assert all(data == whole for data in seen)
    assert sorted(p.name for p in build_dir.iterdir()) == [target.name]


def test_serve_smoke_drill(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.smoke", "--device", "cpu",
         "--workdir", str(tmp_path), "--sweeps", "96"], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "crash drill OK" in proc.stdout
    assert "coalescing OK" in proc.stdout
    assert "serve smoke OK" in proc.stdout
