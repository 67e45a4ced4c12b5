"""The port's Fig. 5/6 scan (``repro_torch.analysis.figures``) on the CPU:
its ``--smoke`` gate, its trajectories against the JAX package's, and
the ensemble observables a chunk of members at a time against one
member at a time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import multispin as jms
from repro_torch.analysis import figures
from repro_torch.api import (BatchSpec, EngineSpec, LatticeSpec, RunSpec,
                             Session, SweepSpec)
from repro_torch.core import engine as engine_mod
from repro_torch.core import multispin as ms


def test_smoke_passes_its_tc_gate(tmp_path, capsys):
    """``--smoke`` on the CPU: the Binder-crossing T_c within 2% of
    Onsager's, and the JAX figure's rows."""
    out = figures.main(["--smoke", "--device", "cpu", "--out",
                        str(tmp_path)])
    assert out["tc"] is not None and out["rel_err"] < figures.TC_TOLERANCE
    assert "smoke OK" in capsys.readouterr().out
    lines = (tmp_path / "fig5_fig6.csv").read_text().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in lines[1:]]
    assert names == [f"fig{f}_L{L}_T{t:.3f}" for L in figures.SMOKE_SIZES
                     for t in figures.TEMPS for f in (5, 6)] + \
        ["fig6_tc_estimate"]


def test_the_scan_is_the_jax_figure_scan():
    """The same temperatures, seeds and sweep plans as the JAX figure."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / "figures.py"
    spec = importlib.util.spec_from_file_location("jax_figures", path)
    jfig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfig)
    assert figures.TEMPS == jfig.TEMPS
    for sizes, sweep in ((figures.SMOKE_SIZES, figures.SMOKE_SWEEP),
                         (figures.FULL_SIZES, figures.FULL_SWEEP)):
        for k, (L, ours) in enumerate(figures.figure_specs(
                sizes, sweep, "multispin").items()):
            theirs = jfig.size_spec(L, jfig.TEMPS, japi.SweepSpec(
                **{f: getattr(sweep, f) for f in ("thermalize",
                                                  "measure_every",
                                                  "n_measure")}),
                "multispin", seed0=101 + 1000 * k)
            assert ours.to_dict() == theirs.to_dict()


def agreeing_temperatures(temps):
    """The temperatures at which the two packages' multispin thresholds
    agree (``ROADMAP.md`` Queue 3: ``jnp.exp`` is not correctly
    rounded)."""
    return [t for t in temps
            if ms.acceptance_thresholds(1.0 / float(t)).tolist()
            == np.asarray(jms.acceptance_thresholds(
                jnp.float32(1.0 / float(t)))).astype(np.int64).tolist()]


def test_trajectories_equal_jax_where_the_tables_agree():
    """From the all-up start (the same lattice in both packages), each
    member's (m, e) trajectory of the figure's scan equals the JAX
    ``Session.measure()`` of the same ``BatchSpec`` at every temperature
    where the thresholds agree, 2.2 among them."""
    sweep = dict(thermalize=10, measure_every=2, n_measure=25)
    spec = figures.size_spec(16, figures.TEMPS, SweepSpec(**sweep),
                             "multispin", 101)
    agree = agreeing_temperatures(figures.TEMPS)
    assert 2.2 in agree
    ours = Session.open(spec, device="cpu").measure()
    theirs = japi.Session.open(japi.RunSpec.from_json(spec.to_json())) \
        .measure()
    for i, t in enumerate(figures.TEMPS):
        if t not in agree:
            continue
        for k in ("m", "e"):
            np.testing.assert_array_equal(
                ours[k][:, i], np.asarray(theirs[k])[:, i],
                err_msg=f"T={t} {k}")
    assert ours["m"].shape == (25, 13) and ours["m"].dtype == np.float32


ENSEMBLE_ENGINES = ("stencil_pallas", "multispin", "multispin_pallas",
                    "bitplane", "bitplane_pallas")


@pytest.mark.parametrize("engine", ENSEMBLE_ENGINES)
@pytest.mark.parametrize("members_a_chunk", [1, 2, 5])
def test_chunked_observables_equal_each_member(engine, members_a_chunk,
                                               monkeypatch):
    """The ensemble's observables, magnetizations and lattices a chunk of
    members at a time equal each member's own bit for bit, whatever the
    chunk (the sums are integers)."""
    spec = RunSpec(lattice=LatticeSpec(32, 64, init_p_up=0.5),
                   engine=EngineSpec(engine),
                   batch=BatchSpec((1.8, 2.2, 2.6, 3.0, 3.4),
                                   (3, 4, 2 ** 31 + 11, 6, 2 ** 32 - 1)))
    session = Session.open(spec, device="cpu")
    session.run(3)
    eng, states = session.engine, session.state
    member_bytes = sum(p[0].numel() * p.element_size() for p in states)
    monkeypatch.setattr(engine_mod, "OBSERVABLE_CHUNK_BYTES",
                        members_a_chunk * member_bytes)
    chunks = eng.member_chunks(states)
    assert [c[0].shape[0] for c in chunks][0] == members_a_chunk
    assert sum(c[0].shape[0] for c in chunks) == 5
    batched = eng.observables_batched(states, session._runner.inv_temps)
    mags = eng.magnetizations(states)
    lattices = eng.full_lattices(states)
    for i in range(5):
        member = eng.member(states, i)
        one = eng.observables(member, session._runner.inv_temps[i])
        for k in ("m", "e"):
            assert torch.equal(batched[k][i], one[k]), (k, i)
        assert torch.equal(mags[i], eng.magnetization(member))
        assert torch.equal(lattices[i], eng.full_lattice(member))
    shape = (5, 32) if eng.replicas > 1 else (5,)
    assert batched["m"].shape == batched["e"].shape == shape


def test_a_chunk_holds_every_small_member_and_one_large_one():
    """At the default bound the figure's 13 x 64^2 scan is one chunk, and
    a member of 8192^2 is a chunk of its own (its state alone, 32 MiB of
    word planes, exceeds the bound)."""
    spec = figures.size_spec(64, figures.TEMPS, figures.FULL_SWEEP,
                             "multispin", 1101)
    session = Session.open(spec, device="cpu")
    assert len(session.engine.member_chunks(session.state)) == 1
    big = tuple(torch.empty((2, 8192, 512), dtype=torch.int32,
                            device="meta") for _ in range(2))
    assert [c[0].shape[0] for c in session.engine.member_chunks(big)] == \
        [1, 1]


@pytest.mark.parametrize("engine", ["stencil_pallas", "multispin",
                                    "bitplane"])
def test_tables_are_made_once_per_temperature(engine):
    """Every member at one inverse temperature gets the one host table,
    made once, equal to the table made afresh."""
    spec = RunSpec(lattice=LatticeSpec(32, 64), engine=EngineSpec(engine),
                   batch=BatchSpec((2.0, 2.5, 2.0), (3, 4, 5)))
    eng = Session.open(spec, device="cpu").engine
    first, second, third = (eng.sweep_context(1 / t) for t in
                            (2.0, 2.5, 2.0))
    assert first is third and first is not second
    fresh = (ms.acceptance_thresholds(0.5) if eng.plane_dtype == np.uint32
             else engine_mod.metro.acceptance_table(0.5))
    assert torch.equal(first, fresh)


def test_cpu_measure_is_the_loop():
    """On the CPU a counter-based measure() runs the loop: no graph, no
    replay, and the plan's samples."""
    from repro_torch.analysis import measure
    spec = RunSpec(lattice=LatticeSpec(32, 64, init_p_up=1.0),
                   engine=EngineSpec("multispin"), temperature=2.0,
                   sweep=SweepSpec(thermalize=2, measure_every=2,
                                   n_measure=3))
    before = measure.DISPATCHES
    got = Session.open(spec, device="cpu").measure()
    assert measure.DISPATCHES == before
    assert got["m"].shape == got["e"].shape == (3,)
