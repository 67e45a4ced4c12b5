#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA source of ``src/repro_torch/csrc`` with nvcc, and
   read each kernel's SASS instruction mix with cuobjdump;
3. each kernel against its plain PyTorch version on the card, 0
   mismatches required, at small shapes and at the main path's full
   plane (32768, 16384); each kernel's time beside the plain version's,
   and both sweep tiers' times at the full size;
4. the Session at 512^2: the card's k-sweep tier, its per-half-sweep
   tier (``resident_budget_bytes=0``) and the CPU plain versions give
   one ``state_digest``, and restore-continue equals the uninterrupted
   run;
5. the main path at 32768^2 (2^30 spins): ``Session.open`` from an
   ordered start at T = 2.0, ``run(200)``, ``measure()`` on the
   planner's tier (k-sweeps); flips/ns, and |m| within 2e-3 of Onsager;
   then the same spec on the per-half-sweep tier, whose planes must
   equal the k-sweep tier's after the same sweeps.

Every Session path is driven with both kernels' launch counts set to 0
just before it and read just after it: each path must launch the kernel
of its tier and not the other.  The last lines are the ``kernels`` JSON
(``launches`` from the full-size path of the kernel's tier, and every
path's count), the peak device memory, the ``nvidia-smi`` line and the
device JSON.  Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FULL_N = 32768
SMALL_N = 512
TEMPERATURE = 2.0
SEED = 2 ** 33 + 5          # both Philox key lanes non-zero
HALF_SWEEP_CHECK = 10       # sweeps of the full-size half-sweep-tier path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
#: instructions per site update that no implementation avoids, by the
#: SM pipe that executes them.  Lane 0 of Philox4x32-10 at counter
#: (offset, 0, site, 0), key and offset the same for every site: 17
#: 32x32 multiplies (a wide one counted once) and 17 three-input XORs,
#: once the rounds' lanes that depend on the offset alone and the last
#: rounds' unused lanes are taken out; then 2 three-input adds
#: (neighbour sum, table index), 1 compare and 1 select; 1 uint32 ->
#: float conversion.  Integer multiplies run on the FMA pipe, logic,
#: adds and compares to the ALU pipe, conversions to the XU pipe, and
#: the pipes run concurrently.
PIPE_OPS_PER_SITE = {"fma": 17, "alu": 21, "xu": 1}
#: results per clock per SM on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput): 32-bit integer
#: multiply 64, add, logic and compare 64, type conversions 16
PIPE_PER_CLOCK_PER_SM = {"fma": 64, "alu": 64, "xu": 16}
#: four schedulers per SM, each dispatching one warp instruction per
#: clock
DISPATCH_PER_CLOCK_PER_SM = 4 * 32
#: SASS opcodes (before the first '.') of each pipe, for the reading of
#: the compiled kernels; what is not listed counts as "other"
SASS_PIPES = {
    "fma": ("IMAD", "IMUL", "FFMA", "FMUL", "FADD"),
    "alu": ("LOP3", "IADD3", "ISETP", "FSETP", "SEL", "FSEL", "SHF", "LEA",
            "PRMT", "IMNMX", "PLOP3"),
    "xu": ("I2F", "F2I", "F2F", "MUFU"),
    "lsu": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events,
    after one untimed call unless ``warmup`` is false."""
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks_per_site() -> float:
    """SM clocks per site update at the busiest pipe, or at the
    dispatch rate where that is lower."""
    pipes = max(PIPE_OPS_PER_SITE[p] / PIPE_PER_CLOCK_PER_SM[p]
                for p in PIPE_OPS_PER_SITE)
    return max(pipes, sum(PIPE_OPS_PER_SITE.values())
               / DISPATCH_PER_CLOCK_PER_SM)


def bound(bytes_moved: float, site_updates: float, sm_clocks_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = site_updates * clocks_per_site() / sm_clocks_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sass_mix(compiler: str, library_path) -> dict:
    """``{kernel: {pipe: count}}`` of the SASS instructions in each
    kernel of a built library (static counts, whole function)."""
    cuobjdump = str(Path(compiler).with_name("cuobjdump"))
    out = subprocess.run([cuobjdump, "-sass", str(library_path)],
                         check=True, capture_output=True, text=True).stdout
    pipe_of = {op: pipe for pipe, ops in SASS_PIPES.items() for op in ops}
    mix = {}
    for chunk in out.split("Function : ")[1:]:
        name = re.search(r"([a-z][a-z_]*_kernel)E", chunk).group(1)
        counts = collections.Counter()
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9]*)", chunk):
            counts[pipe_of.get(op, "other")] += 1
        mix[name] = dict(sorted(counts.items()))
    return mix


def random_planes(torch, n: int, h: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple((torch.randint(0, 2, (n, h), generator=g, device="cuda",
                                dtype=torch.int8) * 2 - 1)
                 for _ in range(2))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.api import LatticeSpec, RunSpec, Session, SweepSpec
    from repro_torch.core import metropolis, observables
    from repro_torch.kernels import _build, resident
    from repro_torch.kernels.stencil import (stencil_sweeps_resident,
                                             stencil_sweeps_resident_plain,
                                             stencil_update,
                                             stencil_update_plain)
    from repro_torch.kernels.stencil.stencil import library

    # -- 1. card -------------------------------------------------------------
    card_line = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_clocks_per_s = props.multi_processor_count * max_sm_mhz * 1e6
    print(f"phase 1: card {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"{props.multi_processor_count} SMs at max {max_sm_mhz:.0f} MHz; "
          f"bound: {clocks_per_site():.6f} SM clocks per site update "
          f"(ops per site by pipe {PIPE_OPS_PER_SITE})")

    # -- 2. build ------------------------------------------------------------
    builds = _build.build()
    for b in builds.values():
        print(f"phase 2: built csrc/{b.name}.cu in {b.seconds:.2f} s")
        for line in b.ptxas_summary():
            print(f"  ptxas {line}")
        for kernel, mix in sass_mix(_build.nvcc(), b.path).items():
            print(f"  SASS {kernel}: {mix}")
    lib = library()
    for k in (1, 4, 8):
        check(lib.stencil_resident_smem_bytes(128, 256, k)
              == resident.smem_bytes(128, 256, k),
              "planner and kernel disagree on shared memory")

    # -- 3. kernels against their plain versions -----------------------------
    h_full = FULL_N // 2
    table = metropolis.acceptance_table(1.0 / TEMPERATURE)
    stats = {"stencil_update": [0, 0, 0, 0.0],     # cases, mismatches,
             "stencil_sweeps_resident": [0, 0, 0, 0.0]}  # max err, plain ms

    def compare(name, got, want, plain_ms=None):
        s = stats[name]
        for a, b in zip(got, want):
            s[0] += 1
            s[1] += int((a != b).sum())
            s[2] = max(s[2], int((a.to(torch.int32) - b.to(torch.int32))
                                 .abs().max()))
        if plain_ms is not None:
            s[3] = plain_ms

    def plain_timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    for (n, h), cases in (
            ((SMALL_N, SMALL_N // 2), [(True, 0, SEED), (False, 7, SEED),
                                       (True, 2 ** 32 - 1, 12345),
                                       (False, 2 ** 32 - 2, 2 ** 40 + 11)]),
            ((FULL_N, h_full), [(True, 2, SEED), (False, 2 ** 32 - 1, SEED)])):
        for is_black, offset, seed in cases:
            target, op = random_planes(torch, n, h, offset + n)
            want, plain_ms = plain_timed(lambda: stencil_update_plain(
                target, op, table, is_black=is_black, seed=seed,
                offset=offset))
            got = stencil_update(target.clone(), op, table,
                                 is_black=is_black, seed=seed, offset=offset)
            torch.cuda.synchronize()
            compare("stencil_update", [got], [want],
                    plain_ms if n == FULL_N else None)

    small_plan = resident.plan_resident("stencil", SMALL_N, SMALL_N)
    full_plan = resident.plan_resident("stencil", FULL_N, FULL_N)
    check(small_plan is not None and full_plan is not None,
          "planner gave no k-sweep plan at the default budget")
    ragged = dataclasses.replace(small_plan, k=2, tile_rows=96,
                                 tile_cols=80)
    for (n, plan, n_sweeps, start) in (
            (SMALL_N, dataclasses.replace(small_plan, k=1), 1, 0),
            (SMALL_N, dataclasses.replace(small_plan, k=3), 3, 2 ** 32 - 3),
            (SMALL_N, ragged, 5, 10),
            (FULL_N, full_plan, full_plan.k, 6)):
        b, w = random_planes(torch, n, n // 2, n_sweeps + n)
        want, plain_ms = plain_timed(lambda: stencil_sweeps_resident_plain(
            b, w, table, n_sweeps=n_sweeps, seed=SEED, start_offset=start))
        got = stencil_sweeps_resident(b, w, table, n_sweeps=n_sweeps,
                                      seed=SEED, start_offset=start,
                                      plan=plan)
        torch.cuda.synchronize()
        compare("stencil_sweeps_resident", got, want,
                plain_ms if n == FULL_N else None)
    for name, (cases, bad, err, _) in stats.items():
        print(f"phase 3: {name}: {cases} plane comparisons with the plain "
              f"version, {bad} mismatches, max abs err {err}")
        check(bad == 0, f"{name} disagrees with its plain version")

    b, w = random_planes(torch, FULL_N, h_full, 1)
    update_ms = timed_ms(torch, lambda: stencil_update(
        b, w, table, is_black=True, seed=SEED, offset=0), reps=20)
    tier_ms = {"half-sweep": 2 * update_ms}
    resident_ms = {}
    for k in (1, 2, 4, 8):
        plan_k = dataclasses.replace(full_plan, k=k)
        resident_ms[k] = timed_ms(torch, lambda: stencil_sweeps_resident(
            b, w, table, n_sweeps=k, seed=SEED, start_offset=0,
            plan=plan_k), reps=max(2, 16 // k))
        tier_ms[f"k-sweep k={k}"] = resident_ms[k] / k
    print(f"phase 3: ms per full sweep of {FULL_N}^2 by tier: " + ", ".join(
        f"{t} {ms:.4f}" for t, ms in tier_ms.items()))
    del b, w

    sites = FULL_N * h_full
    update_bound = bound(3 * sites, sites, sm_clocks_per_s)
    res_bound = bound(4 * sites, 2 * full_plan.k * sites, sm_clocks_per_s)

    # -- 4. Session at 512^2, both tiers and the CPU -----------------------
    wrappers = {"stencil_update": stencil_update,
                "stencil_sweeps_resident": stencil_sweeps_resident}
    tier_kernel = {"k-sweep": "stencil_sweeps_resident",
                   "half-sweep": "stencil_update"}
    launches_by_path = {}

    def drive(path, tier, fn):
        """Run one Session path with every launch count set to 0 just
        before it and read just after it; the path must launch the
        kernel of its tier and no other."""
        for wrapper in wrappers.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: wrapper.launches
                  for name, wrapper in wrappers.items()}
        launches_by_path[path] = counts
        print(f"launches on path {path!r}: {counts}")
        for name, count in counts.items():
            check((count > 0) == (name == tier_kernel[tier]),
                  f"path {path!r} launched {name} {count} times")
        return out

    def budget(tier):
        return 0 if tier == "half-sweep" else None

    small = RunSpec(lattice=LatticeSpec(SMALL_N, SMALL_N, init_p_up=0.5),
                    temperature=2.2, seed=SEED)
    s = Session.open(small, device="cpu")
    s.run(50)
    digests = {"cpu": s.state_digest()}
    for tier in ("k-sweep", "half-sweep"):
        def small_run():
            s = Session.open(small, resident_budget_bytes=budget(tier))
            check((s.engine.resident_plan is not None) == (tier == "k-sweep"),
                  f"{SMALL_N}^2 did not plan the {tier} tier")
            s.run(50)
            return s
        digests[tier] = drive(f"{SMALL_N}^2 {tier}", tier,
                              small_run).state_digest()
    print(f"phase 4: {SMALL_N}^2, 50 sweeps, digests {digests}")
    check(len(set(digests.values())) == 1, "tiers disagree")

    def restore_continue():
        s = Session.open(small)
        s.run(20)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = str(Path(tmp) / "ckpt.npz")
            s.save(ckpt)
            r = Session.restore(ckpt)
        plan = SweepSpec(measure_every=3, n_measure=4).plan()
        s.run(30)
        r.run(30)
        return s, s.measure(plan), r, r.measure(plan)

    s, traj, r, traj_r = drive(f"{SMALL_N}^2 save, restore, measure",
                               "k-sweep", restore_continue)
    print(f"phase 4: restore-continue digest {r.state_digest()}, "
          f"uninterrupted {s.state_digest()}")
    check(r.state_digest() == s.state_digest()
          and all((traj[k] == traj_r[k]).all() for k in traj),
          "restore-continue differs from the uninterrupted run")

    # -- 5. main path at full size, on each tier -----------------------------
    torch.cuda.reset_peak_memory_stats()
    spec = RunSpec(lattice=LatticeSpec(FULL_N, FULL_N, init_p_up=1.0),
                   temperature=TEMPERATURE, seed=SEED,
                   sweep=SweepSpec(thermalize=0, measure_every=10,
                                   n_measure=10))
    main_path = f"{FULL_N}^2 k-sweep"
    half_path = f"{FULL_N}^2 half-sweep"

    def main_run():
        t0 = time.perf_counter()
        session = Session.open(spec)
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        run_ms = timed_ms(torch, lambda: session.run(200), reps=1,
                          warmup=False)
        t0 = time.perf_counter()
        traj = session.measure()
        return session, open_s, run_ms, traj, time.perf_counter() - t0

    session, open_s, run_ms, traj, measure_s = drive(main_path, "k-sweep",
                                                     main_run)
    flips_per_ns = 200 * FULL_N * FULL_N / (run_ms * 1e6)
    m = abs(session.magnetization())
    e = session.energy()
    onsager = observables.onsager_magnetization(TEMPERATURE)
    plan = session.engine.resident_plan
    print(f"phase 5: {main_path}: open {open_s:.2f} s; run(200) "
          f"{run_ms:.1f} ms = {flips_per_ns:.2f} flips/ns (k = {plan.k}); "
          f"measure() {spec.sweep.total_sweeps} sweeps + "
          f"{spec.sweep.n_measure} samples {measure_s:.3f} s; |m| {m:.5f} "
          f"(Onsager {onsager:.5f}), e {e:.5f}, last sample m "
          f"{float(traj['m'][-1]):.5f}")
    check(abs(m - onsager) < 2e-3, "|m| is not within 2e-3 of Onsager")
    peak = torch.cuda.max_memory_allocated()
    del session

    def half_run():
        session = Session.open(spec, resident_budget_bytes=0)
        check(session.engine.resident_plan is None,
              "budget 0 still planned k-sweeps")
        ms = timed_ms(torch, lambda: session.run(HALF_SWEEP_CHECK), reps=1,
                      warmup=False)
        return session, ms

    half, half_ms = drive(half_path, "half-sweep", half_run)
    ref = Session.open(spec)
    ref.run(HALF_SWEEP_CHECK)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(half.state, ref.state))
    print(f"phase 5: {half_path}: run({HALF_SWEEP_CHECK}) {half_ms:.1f} ms "
          f"= {HALF_SWEEP_CHECK * FULL_N * FULL_N / (half_ms * 1e6):.2f} "
          f"flips/ns; planes equal to the k-sweep tier's: {same}")
    check(same, "the tiers' planes differ at full size")
    del half, ref

    def by_path(name):
        return {path: c[name] for path, c in launches_by_path.items()}

    kernels = [
        {"name": "stencil_update", "route": "cuda",
         "source": "src/repro_torch/csrc/stencil.cu",
         "replaces": "src/repro/kernels/stencil/stencil.py:76",
         "launches": launches_by_path[half_path]["stencil_update"],
         "launches_path": half_path,
         "launches_by_path": by_path("stencil_update"),
         "mismatches": stats["stencil_update"][1],
         "max_abs_err": float(stats["stencil_update"][2]),
         "shape": [FULL_N, h_full], "ms": update_ms,
         "plain_ms": stats["stencil_update"][3],
         "bound_ms": update_bound[0], "bound_by": update_bound[1],
         "library_ms": None},
        {"name": "stencil_sweeps_resident", "route": "cuda",
         "source": "src/repro_torch/csrc/stencil.cu",
         "replaces": "src/repro/kernels/stencil/resident.py:91",
         "launches": launches_by_path[main_path]["stencil_sweeps_resident"],
         "launches_path": main_path,
         "launches_by_path": by_path("stencil_sweeps_resident"),
         "mismatches": stats["stencil_sweeps_resident"][1],
         "max_abs_err": float(stats["stencil_sweeps_resident"][2]),
         "shape": [FULL_N, h_full], "n_sweeps": full_plan.k,
         "ms": resident_ms[full_plan.k],
         "plain_ms": stats["stencil_sweeps_resident"][3],
         "bound_ms": res_bound[0], "bound_by": res_bound[1],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"peak device memory of the {main_path} path: {peak} B")
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
