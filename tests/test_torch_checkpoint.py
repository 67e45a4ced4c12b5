"""The port's checkpointer (``repro_torch.ckpt``) on the CPU.

The behaviours of ``tests/test_checkpoint.py`` on the port: atomic
steps, GC, async writes and their failures, typed errors, fallback past
a corrupt step, and restores onto another placement (the arrays come
back on the host, the caller places them: a sharded run resumes on
another mesh or none).  Against the JAX package: a step directory
written by ``repro.ckpt.Checkpointer`` validates and restores under the
port's, and one written by the port under the JAX package's, with the
same manifest records.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import EngineSpec, LatticeSpec, MeshSpec, RunSpec
from repro_torch.api.session import Session
from repro_torch.ckpt import Checkpointer, CheckpointError
from repro_torch.resilience import faults, integrity


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(6).reshape(2, 3),
                       "c": [torch.ones(3), torch.zeros(2)]}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(3, t)
    step, r = ck.restore(t)
    assert step == 3
    assert isinstance(r["nested"]["c"], list)
    for a, b in zip(_leaves(t), _leaves(r)):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a.numpy(), b)


def test_partial_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = tmp_path / "step_0000000002"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 1


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_on_the_callers_thread(tmp_path):
    """``save_async`` copies the tensors to the host before it returns:
    changing them afterwards does not change the step written."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = [x.clone() for x in _leaves(t)]
    ck.save_async(7, t)
    for x in _leaves(t):
        x.add_(1)
    ck.wait()
    step, r = ck.restore(t)
    assert step == 7
    for a, b in zip(want, _leaves(r)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_manifest_committed_under_done(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(4, _tree())
    manifest = integrity.load_manifest(str(tmp_path / "step_0000000004"))
    assert manifest["step"] == 4
    assert "arrays.npz" in manifest["files"]
    assert set(manifest["arrays"]) == {"a", "nested/b", "nested/c/0",
                                       "nested/c/1"}
    assert ck.validate_step(4) == []


def test_async_writer_error_rethrown(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(np, "savez", boom)
    ck.save_async(1, _tree())
    with pytest.raises(CheckpointError, match="disk full"):
        ck.wait()
    monkeypatch.undo()
    ck.save(2, _tree())
    assert ck.latest_step() == 2
    ck.close()


def test_restore_shape_mismatch_typed_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": np.zeros((4, 4))})
    with pytest.raises(CheckpointError) as ei:
        ck.restore({"a": np.zeros((8, 2))})
    assert "'a'" in str(ei.value)
    assert "(4, 4)" in str(ei.value) and "(8, 2)" in str(ei.value)
    with pytest.raises(CheckpointError, match="missing array"):
        ck.restore({"other": np.zeros((4, 4))})


def test_missing_checkpoint_typed_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(CheckpointError, match="no checkpoint"):
        ck.restore({"a": np.zeros(2)})
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        ck.read_spec()


def test_restore_falls_back_past_corrupt_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=0)
    t = _tree()
    ck.save(1, t)
    ck.save(2, t)
    faults.flip_byte(str(tmp_path), 2)
    step, r = ck.restore(t)
    assert step == 1
    assert (tmp_path / "quarantine_step_0000000002").exists()


def test_restore_places_onto_any_device(tmp_path):
    """The arrays come back on the host; the caller places them."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t)
    _, r = ck.restore(t)
    placed = torch.as_tensor(r["a"], device="cpu")
    assert torch.equal(placed, t["a"])


@pytest.mark.parametrize("resume_mesh", [(1, 2), (4, 1), None],
                         ids=["1x2", "4x1", "single"])
def test_sharded_state_resumes_on_another_mesh(tmp_path, resume_mesh):
    """A 2 x 2 mesh run's step, restored as host arrays, resumes on
    another mesh or in single mode to the uninterrupted digest."""
    spec = RunSpec(lattice=LatticeSpec(16, 16, init_p_up=1.0),
                   engine=EngineSpec("stencil_pallas"), temperature=2.2,
                   seed=5, mesh=MeshSpec((2, 2), ("data", "model")))
    ref = Session.open(spec, device="cpu")
    ref.run(6)
    s = Session.open(spec, device="cpu")
    s.run(2)
    ck = Checkpointer(str(tmp_path))
    ck.save(s.step_count, s._runner.state_arrays(),
            spec_json=s.spec.to_json())
    step, arrays = ck.load_arrays()
    other = RunSpec.from_json(ck.read_spec(step))
    other = RunSpec(lattice=other.lattice, engine=other.engine,
                    temperature=other.temperature, seed=other.seed,
                    mesh=None if resume_mesh is None
                    else MeshSpec(resume_mesh, ("data", "model")))
    r = Session._from_arrays(other, arrays, step, device="cpu")
    r.run(4)
    assert r.state_digest() == ref.state_digest()


# ---------------------------------------------------------------------------
# against the JAX package: one layout, either writer, either reader
# ---------------------------------------------------------------------------

def _manifest_records(manifest):
    """The manifest without the files' CRCs, which cover the npz
    container's timestamps: format, step, the files' names, and every
    array's record (CRC32C, bytes, shape, dtype)."""
    return {"format": manifest["format"], "algo": manifest["algo"],
            "step": manifest["step"], "files": sorted(manifest["files"]),
            "arrays": manifest["arrays"]}


def _session_arrays():
    spec = RunSpec(lattice=LatticeSpec(16, 32, init_p_up=0.5),
                   engine=EngineSpec("multispin"), temperature=2.0, seed=3)
    s = Session.open(spec, device="cpu")
    s.run(3)
    return spec, s._runner.state_arrays()


def test_jax_step_restores_here(tmp_path):
    from repro.ckpt import Checkpointer as JaxCheckpointer
    spec, arrays = _session_arrays()
    JaxCheckpointer(str(tmp_path)).save(3, arrays,
                                        spec_json=spec.to_json())
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 3 and ck.validate_step(3) == []
    step, got = ck.load_arrays()
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    assert RunSpec.from_json(ck.read_spec()).to_dict() == spec.to_dict()
    ours = tmp_path / "ours"
    Checkpointer(str(ours)).save(3, arrays, spec_json=spec.to_json())
    assert _manifest_records(integrity.load_manifest(
        str(tmp_path / "step_0000000003"))) == _manifest_records(
        integrity.load_manifest(str(ours / "step_0000000003")))


def test_port_step_restores_in_jax(tmp_path):
    from repro.ckpt import Checkpointer as JaxCheckpointer
    from repro.resilience import integrity as jintegrity
    spec, arrays = _session_arrays()
    tensors = {k: torch.from_numpy(v.view(np.int32)) for k, v in
               arrays.items()}
    # the port writes what it is given: the session's uint32 arrays
    Checkpointer(str(tmp_path)).save(3, arrays, spec_json=spec.to_json())
    jck = JaxCheckpointer(str(tmp_path))
    assert jck.latest_step() == 3 and jck.validate_step(3) == []
    step, got = jck.load_arrays()
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    assert jck.read_spec() == spec.to_json()
    assert jintegrity.load_manifest(str(tmp_path / "step_0000000003")) \
        == integrity.load_manifest(str(tmp_path / "step_0000000003"))
    # tensors are copied to the host with their own dtype
    Checkpointer(str(tmp_path / "t")).save(1, tensors)
    _, got = JaxCheckpointer(str(tmp_path / "t")).load_arrays()
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v.numpy())
