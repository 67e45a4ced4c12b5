"""The port's resilience layer (``repro_torch.resilience``) on the CPU.

The behaviours of ``tests/test_resilience.py`` on the port: CRC32C,
the crash topologies ``latest_step`` skips, quarantine and fallback,
fault plans, retry and demotion bit for bit, and the supervisor's
bit-exact resume in all three runner modes.  The port's own rules: the
CUDA launch errors classify by their code (which demote, which
propagate, which poison the context), a dispatch whose per-half-sweep
launches have written its state is never retried, and a failure in a
k-sweep or shard dispatch restarts from its untouched inputs on every
tier.  Against the JAX package: a ``--supervise`` directory the JAX
supervisor left interrupted resumes under the port's ``Supervisor`` to
the JAX package's uninterrupted digest, and the chaos drill runs through
the CLI in subprocesses.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.telemetry as tel
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, MeshSpec,
                             RunSpec)
from repro_torch.api.session import Session
from repro_torch.ckpt import (Checkpointer, CheckpointError,
                              CheckpointIntegrityError)
from repro_torch.kernels import errors as kernel_errors
from repro_torch.resilience import (FaultPlanError,
                                    SimulatedResourceExhausted, Supervisor,
                                    SupervisorError, TransientDispatchError,
                                    degrade, faults, integrity)
from repro_torch.resilience.__main__ import main as resilience_cli

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


def _spec(engine="multispin", n=16, m=32, seed=7, temperature=2.1, **kw):
    return RunSpec(lattice=LatticeSpec(n, m), engine=EngineSpec(engine),
                   temperature=temperature, seed=seed, **kw)


def _open(spec, **kw):
    return Session.open(spec, device="cpu", **kw)


def _counter(name):
    return tel.REGISTRY.counter(name).value


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

def test_crc32c_known_vectors():
    assert integrity.crc32c(b"") == 0
    assert integrity.crc32c(b"123456789") == 0xE3069283
    assert integrity.crc32c(b"The quick brown fox jumps over "
                            b"the lazy dog") == 0x22620404


def test_crc32c_incremental_chaining():
    a, b = b"hello, ", b"world" * 500
    assert integrity.crc32c(b, integrity.crc32c(a)) \
        == integrity.crc32c(a + b)


def test_crc32c_ladder_matches_scalar_oracle():
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 2047, 2048, 2049, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        init = int(rng.integers(0, 2 ** 32))
        assert integrity._crc32c_numpy(data, init) \
            == integrity._crc32c_scalar(data, init), n


# ---------------------------------------------------------------------------
# crash topologies: latest_step must skip every invalid shape
# ---------------------------------------------------------------------------

def _save_steps(tmp_path, steps=(10, 20, 30)):
    ck = Checkpointer(str(tmp_path), keep=0)
    for s in steps:
        ck.save(s, {"a": np.arange(s, dtype=np.int64)})
    return ck


#: corrupt step 30 (or write a torn step 40): the problem validate_step
#: names (None: the torn step is not committed at all) and latest_step
TOPOLOGIES = {
    "kill-mid-write": (lambda d: faults.kill_mid_write(d, 40), None, 30),
    "truncate": (lambda d: faults.truncate_arrays(d, 30), "truncated", 20),
    "stale-done": (lambda d: faults.stale_done(d, 30), "stale", 20),
    "flip-byte": (lambda d: faults.flip_byte(d, 30), "CRC32C", 20),
}


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_latest_step_skips_crash_topology(tmp_path, topology):
    corrupt, problem, latest = TOPOLOGIES[topology]
    ck = _save_steps(tmp_path)
    corrupt(ck.dir)
    if problem is not None:
        assert any(problem in p for p in ck.validate_step(30))
    assert ck.latest_step() == latest


def test_latest_step_survives_pruning_race(tmp_path, monkeypatch):
    ck = _save_steps(tmp_path)
    real = Checkpointer.all_steps
    monkeypatch.setattr(Checkpointer, "all_steps",
                        lambda self: real(self) + [40])
    assert ck.latest_step() == 30
    step, arrays = ck.load_arrays()
    assert step == 30


def test_quarantine_and_fallback_restore(tmp_path):
    ck = _save_steps(tmp_path)
    faults.flip_byte(ck.dir, 30)
    before = _counter("ckpt.quarantine")
    step, arrays = ck.load_arrays()
    assert step == 20
    np.testing.assert_array_equal(arrays["a"],
                                  np.arange(20, dtype=np.int64))
    assert _counter("ckpt.quarantine") == before + 1
    names = sorted(os.listdir(ck.dir))
    assert "quarantine_step_0000000030" in names
    assert "step_0000000030" not in names


def test_explicit_step_integrity_error_names_problem(tmp_path):
    ck = _save_steps(tmp_path)
    faults.flip_byte(ck.dir, 30)
    with pytest.raises(CheckpointIntegrityError, match="CRC32C"):
        ck.load_arrays(step=30)
    assert ck.all_steps() == [10, 20, 30]


def test_verify_arrays_names_offending_key():
    a = {"good": np.arange(4), "bad": np.arange(8)}
    manifest = {"arrays": {k: integrity._array_record(v)
                           for k, v in a.items()}}
    a["bad"] = a["bad"] + 1
    problems = integrity.verify_arrays(a, manifest)
    assert len(problems) == 1 and "'bad'" in problems[0]
    assert integrity.verify_arrays(a, None) == []


def test_exhausted_checkpoints_raise_typed_error(tmp_path):
    ck = _save_steps(tmp_path, steps=(10,))
    faults.flip_byte(ck.dir, 10)
    with pytest.raises(CheckpointError, match="failed verification"):
        ck.load_arrays()
    with pytest.raises(CheckpointError, match="no checkpoint"):
        Checkpointer(str(tmp_path / "empty")).load_arrays()


def test_resilience_cli_corrupt_and_validate(tmp_path, capsys):
    ck = _save_steps(tmp_path)
    assert resilience_cli(["validate", ck.dir]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["latest_valid_step"] == 30
    assert resilience_cli(["corrupt", ck.dir, "--mode", "truncate"]) == 0
    capsys.readouterr()
    assert resilience_cli(["validate", ck.dir]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["latest_valid_step"] == 20
    assert not report["steps"]["30"]["valid"]


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

def test_fault_plan_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", '{"transient_dispatches": 2}')
    plan = faults.install_from_env()
    assert plan.transient_dispatches == 2
    assert faults.active_plan() is plan
    monkeypatch.setenv("REPRO_FAULTS", '{"bogus": 1}')
    with pytest.raises(FaultPlanError, match="unknown fault kind"):
        faults.install_from_env()
    monkeypatch.delenv("REPRO_FAULTS")
    faults.clear()
    assert faults.install_from_env() is None


@pytest.mark.parametrize("text,match", [
    ('{"transient_dispatches": 2', "malformed JSON"),
    ('[1, 2]', "must be a JSON object"),
    ('{"bogus": 1}', "unknown fault kind"),
    ('{"transient_dispatches": "two"}', "must be an integer"),
    ('{"transient_dispatches": true}', "must be an integer"),
    ('{"resident_oom": -1}', "must be >= 0"),
])
def test_fault_plan_failures_are_typed_and_diagnosable(text, match):
    with pytest.raises(FaultPlanError, match=match) as ei:
        faults.FaultPlan.from_json(text)
    assert ei.value.text == text
    assert repr(text) in str(ei.value)


# ---------------------------------------------------------------------------
# classification of failures: CUDA codes, built by hand
# ---------------------------------------------------------------------------

def _launch_error(code):
    return kernel_errors.CudaLaunchError("multispin_sweeps_resident", code,
                                         "by hand")


#: (failure, demotes, sticky): what is_resident_oom and is_sticky say
CLASSES = {
    "memory-allocation-2": (lambda: _launch_error(2), True, False),
    "out-of-resources-701": (lambda: _launch_error(701), True, False),
    "shared-memory-overflow": (
        lambda: kernel_errors.SharedMemoryOverflow("x", 300000, 232448),
        True, False),
    "torch-out-of-memory": (
        lambda: torch.cuda.OutOfMemoryError("CUDA out of memory."), True,
        False),
    "simulated": (lambda: SimulatedResourceExhausted(), True, False),
    "invalid-value-1": (lambda: _launch_error(1), False, False),
    "illegal-address-700": (lambda: _launch_error(700), False, True),
    "misaligned-716": (lambda: _launch_error(716), False, True),
    "launch-failure-719": (lambda: _launch_error(719), False, True),
    "other": (lambda: RuntimeError("RESOURCE_EXHAUSTED UNAVAILABLE"),
              False, False),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_failure_classification_by_code(case):
    """Demotable: codes 2 and 701, a shared-memory overflow, torch's
    OutOfMemoryError, the injected stand-in; sticky: 700, 716, 719; no
    CUDA code is transient, and no message text decides anything."""
    make, demotes, sticky = CLASSES[case]
    exc = make()
    assert degrade.is_resident_oom(exc) is demotes
    assert degrade.is_sticky(exc) is sticky
    assert not degrade.is_transient(exc)
    if isinstance(exc, kernel_errors.CudaLaunchError):
        assert exc.code == (1 if case == "shared-memory-overflow"
                            else int(case.rsplit("-", 1)[1]))
        assert isinstance(exc, RuntimeError)
        assert f"CUDA error {exc.code}" in str(exc)
    assert degrade.is_transient(TransientDispatchError("x"))


def test_launch_error_message_unchanged():
    """raise_on_error keeps the message text the launchers raised before
    it became typed."""
    class Lib:
        @staticmethod
        def cuda_error_string(rc):
            return b"out of memory"
    with pytest.raises(kernel_errors.CudaLaunchError,
                       match=r"^stencil_update launch failed: CUDA error 2 "
                             r"\(out of memory\)$") as ei:
        kernel_errors.raise_on_error(Lib, 2, "stencil_update")
    assert ei.value.code == 2 and ei.value.what == "stencil_update"
    kernel_errors.raise_on_error(Lib, 0, "stencil_update")


def test_shared_memory_check_reads_the_card_limit(monkeypatch):
    class Lib:
        @staticmethod
        def stencil_resident_smem_bytes(rows, cols, k):
            return rows * cols

    monkeypatch.setitem(kernel_errors._OPTIN_BYTES, 0, 232448)
    cuda = torch.device("cuda", 0)
    kernel_errors.check_shared_memory(Lib, "x", cuda,
                                      "stencil_resident_smem_bytes", 64, 512,
                                      2)
    with pytest.raises(kernel_errors.SharedMemoryOverflow) as ei:
        kernel_errors.check_shared_memory(
            Lib, "x", cuda, "stencil_resident_smem_bytes", 1024, 512, 2)
    assert (ei.value.need, ei.value.limit, ei.value.code) == \
        (1024 * 512, 232448, kernel_errors.INVALID_VALUE)
    # planes on the CPU have no such limit
    kernel_errors.check_shared_memory(Lib, "x", torch.device("cpu"),
                                      "no_such_query", 1 << 20, 1 << 20)


# ---------------------------------------------------------------------------
# dispatch recovery: retry and demotion, bit for bit, on every tier
# ---------------------------------------------------------------------------

#: (engine, mode): single, ensemble and sharded; the three families
#: (their _pallas engines: the k-sweep and shard tiers) and basic_philox
RECOVERY_CASES = [(e, mode) for e in ("stencil_pallas", "multispin_pallas",
                                      "bitplane_pallas", "basic_philox")
                  for mode in ("single", "ensemble", "sharded")]


def _mode_spec(engine, mode):
    """16 x 16 (multispin 16 x 32); sharded, 48 x 96 (multispin 48 x 768)
    on a 2 x 1 mesh, whose shards the shard planner fits."""
    n, m = (48, 96) if mode == "sharded" else (16, 16)
    if engine.startswith("multispin"):
        m *= 8 if mode == "sharded" else 2
    kw = {}
    if mode == "ensemble":
        kw["batch"] = BatchSpec(temperatures=(2.0, 2.4))
    if mode == "sharded":
        kw["mesh"] = MeshSpec((2, 1), ("data", "model"))
    return _spec(engine, n=n, m=m, **kw)


@pytest.mark.parametrize("engine,mode", RECOVERY_CASES)
def test_transient_retry_is_bit_exact_on_every_tier(nosleep, engine, mode):
    ref = _open(_mode_spec(engine, mode))
    ref.run(6)
    before = _counter("resilience.retry")
    s = _open(_mode_spec(engine, mode))
    with faults.injected(faults.FaultPlan(transient_dispatches=2)) as p:
        s.run(6)
    assert p.fired == {"transient_dispatch": 2}
    assert _counter("resilience.retry") == before + 2
    assert s.state_digest() == ref.state_digest()


def test_retry_budget_exhausts(nosleep):
    s = _open(_spec())
    with faults.injected(faults.FaultPlan(transient_dispatches=99)):
        with pytest.raises(TransientDispatchError):
            s.run(4)
    assert faults.active_plan() is None


def test_resident_oom_demotes_bit_exact():
    """An injected out-of-memory demotes the (family, lattice), restarts
    at once on the per-half-sweep tier, and the trajectory does not fork;
    a fresh engine on the same lattice starts demoted, and the dry-run
    plan says so."""
    from repro_torch.api import describe
    ref = _open(_spec("multispin_pallas"))
    assert ref.engine.resident_plan is not None
    ref.run(6)
    before = _counter("resident.demote")
    s = _open(_spec("multispin_pallas"))
    with faults.injected(faults.FaultPlan(resident_oom=1)) as p:
        s.run(6)
    assert p.fired == {"resident_oom": 1}
    assert s.engine.resident_plan is None
    assert s.state_digest() == ref.state_digest()
    assert _counter("resident.demote") == before + 1
    assert degrade.demotion_reason("multispin", 16, 32).startswith(
        "SimulatedResourceExhausted")
    fresh = _open(_spec("multispin_pallas"))
    assert fresh.engine.resident_plan is None
    assert fresh.engine.resident_attrs["demoted"] is True
    assert "per-half-sweep" in fresh.engine.resident_attrs["reason"]
    assert describe(_spec("multispin_pallas"))["resident"]["demoted"]


@pytest.mark.parametrize("engine,mode", [
    (e, mode) for e in ("stencil_pallas", "multispin_pallas",
                        "bitplane_pallas")
    for mode in ("single", "ensemble", "sharded")])
def test_injected_demotion_bit_exact_on_every_tier(engine, mode):
    """Single and ensemble runs drop their k-sweep plan; a sharded run
    drops its shard plan for the per-half-sweep distributed step."""
    ref = _open(_mode_spec(engine, mode))
    m_ref = ref.run(5)
    s = _open(_mode_spec(engine, mode))
    if mode == "sharded":
        assert s.shard_plan is not None
    with faults.injected(faults.FaultPlan(resident_oom=1)):
        m = s.run(5)
    if mode == "ensemble":
        np.testing.assert_array_equal(m, m_ref)
    if mode == "sharded":
        assert s.shard_plan is None
        assert s._runner._dist_attrs["demoted"] is True
        assert s.halo_exchanges == 2 * 5   # the per-half-sweep tier's
    else:
        assert s.engine.resident_plan is None
    assert s.state_digest() == ref.state_digest()


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin_pallas",
                                    "bitplane_pallas"])
def test_real_launch_failure_in_a_later_k_sweep_block_restarts(engine):
    """Code 2 from the third launch of a k-sweep dispatch: the k-sweep
    tier leaves its inputs as they were, so the dispatch restarts from
    them on the per-half-sweep tier and the trajectory does not fork."""
    ref = _open(_spec(engine))
    ref.run(6)
    s = _open(_spec(engine))
    real = s.engine.resident_sweeps
    calls = []

    def third_fails(states, tables, seeds, start, n_sweeps):
        # the k-sweep tier's blocks, one call each, out of place
        k = s.engine.resident_plan.k
        for first in range(0, n_sweeps, k):
            calls.append(first)
            if len(calls) == 3:
                raise _launch_error(2)
            states = real(states, tables, seeds,
                          start + 2 * first, min(k, n_sweeps - first))
        return states

    s.engine.resident_sweeps = third_fails
    s.run(6)
    assert len(calls) == 3 and s.engine.resident_plan is None
    assert s.state_digest() == ref.state_digest()


def test_sticky_error_propagates_without_demotion():
    s = _open(_spec("multispin_pallas"))
    before = s.state_digest()

    def poisoned(*args, **kwargs):
        raise _launch_error(700)

    s.engine.resident_sweeps = poisoned
    with faults.injected(faults.FaultPlan()):
        with pytest.raises(kernel_errors.CudaLaunchError) as ei:
            s.run(2)
    assert ei.value.sticky
    assert s.engine.resident_plan is not None
    assert degrade.demotions() == {}
    assert s.state_digest() == before


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin_pallas",
                                    "bitplane_pallas", "tensorcore"])
def test_half_sweep_dispatch_not_retried_after_first_write(
        nosleep, monkeypatch, engine):
    """A transient failure after the first in-place half-sweep of a
    dispatch propagates: the state has moved, and running the dispatch
    again would apply that half-sweep twice."""
    from repro_torch.kernels.tensorcore import ops as tc_ops
    params = {"tc_block": 4} if engine == "tensorcore" else {}
    spec = RunSpec(lattice=LatticeSpec(16, 32 if "multispin" in engine
                                       else 16),
                   engine=EngineSpec(engine, params), temperature=2.1,
                   seed=7)
    s = _open(spec, resident_budget_bytes=0)
    planes = list(s.state.values()) if engine == "tensorcore" \
        else list(s.state)
    before = [p.clone() for p in planes]
    retries = _counter("resilience.retry")
    # the half-sweep: the engine's colour update, or the tensor-core
    # kernel's wrapper as its sweep loop calls it
    target, name = (tc_ops, "tensorcore_update") if engine == "tensorcore" \
        else (s.engine, "color_update")
    real = getattr(target, name)

    def once(*args, **kwargs):
        real(*args, **kwargs)
        raise TransientDispatchError("after the first launch")

    monkeypatch.setattr(target, name, once)
    with pytest.raises(TransientDispatchError):
        s.run(3)
    assert _counter("resilience.retry") == retries
    assert any(not torch.equal(a, b) for a, b in zip(before, planes))


def test_transient_before_any_write_is_retried(nosleep):
    """A transient failure raised before the dispatch's first in-place
    write is retried (the state has not moved)."""
    ref = _open(_spec("stencil_pallas"), resident_budget_bytes=0)
    ref.run(3)
    s = _open(_spec("stencil_pallas"), resident_budget_bytes=0)
    real = s.engine.color_update
    failed = []

    def first_fails(*args, **kwargs):
        if not failed:
            failed.append(1)
            raise TransientDispatchError("before the first launch")
        return real(*args, **kwargs)

    s.engine.color_update = first_fails
    s.run(3)
    assert failed and s.state_digest() == ref.state_digest()


# ---------------------------------------------------------------------------
# supervisor: bit-exact resume across all three runner modes
# ---------------------------------------------------------------------------

def _stop_at(step):
    def hook(sup):
        if sup.session.step_count >= step:
            sup.request_stop()
    return hook


_MODE_SPECS = {
    "single": lambda: _spec("basic", n=16, m=16),
    "ensemble": lambda: _spec(batch=BatchSpec(temperatures=(2.0, 2.4))),
    "sharded": lambda: _spec("basic_philox", n=16, m=16,
                             mesh=MeshSpec((1, 1), ("data", "model"))),
}


def _sup(spec, d, **kw):
    return Supervisor(spec, d, device="cpu", **kw)


@pytest.mark.parametrize("mode", sorted(_MODE_SPECS))
def test_supervised_resume_bit_exact(tmp_path, mode):
    make = _MODE_SPECS[mode]
    ref = _sup(make(), str(tmp_path / "ref"), chunk=4,
               every_sweeps=8).run(22)
    assert ref.completed and ref.status == "completed"
    d = str(tmp_path / "int")
    r1 = _sup(make(), d, chunk=4, every_sweeps=8,
              on_chunk=_stop_at(12)).run(22)
    assert r1.status == "preempted" and r1.step_count == 12
    before = _counter("resilience.resume")
    sup2 = _sup(make(), d, chunk=4, every_sweeps=8)
    assert sup2.session.mode == mode
    assert sup2.resumed_from == 12
    assert _counter("resilience.resume") == before + 1
    r2 = sup2.run(22)
    assert r2.completed and r2.digest == ref.digest
    ref_sess = _sup(make(), str(tmp_path / "ref"), chunk=4).session
    assert torch.equal(sup2.session.full_lattice(),
                       ref_sess.full_lattice())
    np.testing.assert_array_equal(np.asarray(sup2.session.magnetization()),
                                  np.asarray(ref_sess.magnetization()))


@pytest.mark.parametrize("mode", sorted(_MODE_SPECS))
def test_supervised_resume_after_corruption(tmp_path, mode):
    """The newest checkpoint corrupted: resume skips it for the previous
    good step (without quarantining it, as the JAX supervisor does) and
    still converges to the uninterrupted digest."""
    make = _MODE_SPECS[mode]
    ref = _sup(make(), str(tmp_path / "ref"), chunk=4).run(22)
    d = str(tmp_path / "chaos")
    r1 = _sup(make(), d, chunk=4, every_sweeps=4,
              on_chunk=_stop_at(12)).run(22)
    assert r1.checkpoints_written[-2:] == [8, 12]
    faults.flip_byte(d, 12)
    quarantined = _counter("ckpt.quarantine")
    sup = _sup(make(), d, chunk=4, every_sweeps=4)
    assert sup.resumed_from == 8
    assert _counter("ckpt.quarantine") == quarantined
    assert sup.run(22).digest == ref.digest


def test_supervised_resume_on_another_mesh(tmp_path):
    """A mesh-only spec difference resumes the stored trajectory on the
    requested mesh."""
    spec = _spec("stencil_pallas", n=16, m=16,
                 mesh=MeshSpec((2, 1), ("data", "model")))
    ref = _sup(spec, str(tmp_path / "ref"), chunk=4).run(12)
    d = str(tmp_path / "m")
    _sup(spec, d, chunk=4, on_chunk=_stop_at(4)).run(12)
    other = _spec("stencil_pallas", n=16, m=16,
                  mesh=MeshSpec((1, 2), ("data", "model")))
    sup = _sup(other, d, chunk=4)
    assert sup.resumed_from == 4 and sup.session.spec.mesh.shape == (1, 2)
    assert sup.run(12).digest == ref.digest


def test_supervisor_rejects_spec_mismatch(tmp_path):
    d = str(tmp_path)
    _sup(_spec(seed=7), d, chunk=4, on_chunk=_stop_at(4)).run(8)
    with pytest.raises(SupervisorError, match="different spec"):
        _sup(_spec(seed=8), d, chunk=4)


def test_supervisor_requires_spec_or_checkpoint(tmp_path):
    with pytest.raises(SupervisorError, match="no spec"):
        _sup(None, str(tmp_path))


def test_supervisor_sigterm_checkpoints_and_resumes(tmp_path):
    ref = _sup(_spec(), str(tmp_path / "ref"), chunk=4).run(12)
    d = str(tmp_path / "sig")

    def send_sigterm(sup):
        if sup.session.step_count == 4:
            os.kill(os.getpid(), signal.SIGTERM)

    r1 = _sup(_spec(), d, chunk=4, on_chunk=send_sigterm).run(12)
    assert r1.status == "preempted"
    assert r1.stop_signal == signal.SIGTERM
    assert r1.checkpoints_written
    r2 = _sup(_spec(), d, chunk=4).run(12)
    assert r2.completed and r2.digest == ref.digest


def test_supervisor_resume_from_spec_in_checkpoint(tmp_path):
    d = str(tmp_path)
    _sup(_spec(), d, chunk=4, on_chunk=_stop_at(4)).run(12)
    sup = _sup(None, d, chunk=4)
    assert sup.resumed_from == 4
    assert sup.session.spec.to_dict() == _spec().to_dict()
    assert sup.run(12).completed


def test_supervisor_zero_cadence_writes_no_periodic_steps(tmp_path):
    d = str(tmp_path)
    res = _sup(_spec(), d, chunk=4).run(12)
    assert res.completed
    assert res.checkpoints_written == []
    assert os.listdir(d) == []


# ---------------------------------------------------------------------------
# against the JAX package: its supervised directory, interrupted, resumes
# here to its uninterrupted digest
# ---------------------------------------------------------------------------

#: counter-based engines at temperatures whose acceptance tables the two
#: packages share (2.0 and 2.2)
JAX_RESUME_SPECS = {
    "single-multispin": lambda api: api.RunSpec(
        lattice=api.LatticeSpec(16, 32), engine=api.EngineSpec("multispin"),
        temperature=2.0, seed=2 ** 33 + 5),
    "single-basic_philox": lambda api: api.RunSpec(
        lattice=api.LatticeSpec(16, 16),
        engine=api.EngineSpec("basic_philox"), temperature=2.2, seed=9),
    "ensemble-multispin": lambda api: api.RunSpec(
        lattice=api.LatticeSpec(16, 32), engine=api.EngineSpec("multispin"),
        temperature=2.0, seed=3,
        batch=api.BatchSpec(temperatures=(2.0, 2.2))),
    "sharded-basic_philox": lambda api: api.RunSpec(
        lattice=api.LatticeSpec(16, 16),
        engine=api.EngineSpec("basic_philox"), temperature=2.2, seed=9,
        mesh=api.MeshSpec((1, 1), ("data", "model"))),
}


@pytest.mark.parametrize("case", sorted(JAX_RESUME_SPECS))
def test_jax_supervised_directory_resumes_here(tmp_path, case):
    import repro.api as japi
    from repro.resilience import Supervisor as JaxSupervisor
    from repro_torch import api
    jspec = JAX_RESUME_SPECS[case](japi)
    ref = JaxSupervisor(jspec, str(tmp_path / "ref"), chunk=4).run(16)
    d = str(tmp_path / "jax")
    r1 = JaxSupervisor(jspec, d, chunk=4, every_sweeps=4,
                       on_chunk=_stop_at(8)).run(16)
    assert r1.status == "preempted" and r1.checkpoints_written[-1] == 8
    faults.flip_byte(d, 8)
    spec = JAX_RESUME_SPECS[case](api)
    sup = _sup(spec, d, chunk=4, every_sweeps=4)
    assert sup.resumed_from == 4
    res = sup.run(16)
    assert res.completed and res.digest == ref.digest
    # and the step the port wrote resumes under the JAX supervisor
    back = JaxSupervisor(jspec, d, chunk=4)
    assert back.resumed_from == 16
    assert back.run(16).digest == ref.digest


# ---------------------------------------------------------------------------
# the chaos drill through the CLI, in subprocesses
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("extra", [["--temps", "2.0,2.4"],
                                   ["--mesh", "2x2", "--resume-mesh", "1x2"]],
                         ids=["ensemble", "mesh"])
def test_chaos_drill(tmp_path, extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.resilience.chaos", "--device",
         "cpu", "--workdir", str(tmp_path), "--n", "32", "--engine",
         "multispin_pallas", "--sweeps", "48", "--every", "16", "--chunk",
         "8", *extra], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "chaos drill OK" in proc.stdout


def test_cli_supervise_exit_codes(tmp_path, capsys):
    """``--supervise`` without ``--sweeps`` exits 2; a completed run 0 and
    its digest; the same command again resumes from the final step."""
    from repro_torch import __main__ as cli
    d = str(tmp_path / "ck")
    args = ["run", "--device", "cpu", "--n", "16", "--init-p-up", "1.0",
            "--supervise", d, "--ckpt-every-sweeps", "8", "--chunk", "4"]
    assert cli.main(args) == 2
    assert cli.main(args + ["--sweeps", "12"]) == 0
    out = capsys.readouterr().out
    digest = [l for l in out.splitlines()
              if l.startswith("final_state_digest=")]
    assert "checkpoints written: [8, 12]" in out and len(digest) == 1
    assert cli.main(args + ["--sweeps", "12"]) == 0
    out = capsys.readouterr().out
    assert "# resumed from step 12" in out and digest[0] in out
