"""The oracle's device greedy pass (``backend="device"``) against the JAX
package's ``backend="jax"``.

On the CPU the port's device pass runs ``greedy_pass_plain``, the plain
version of ``csrc/oracle_greedy.cu``: the host-sorted entries cast to
int32/float32 and walked with float32 adds, as ``repro``'s jitted
``fori_loop`` walks them.  ``solve``, ``learn_window`` and ``run`` with
``backend="device", device="cpu"`` must equal ``repro`` with
``backend="jax"`` bit for bit: allocation, capacity curve, rho curve,
float32 work widened to float64, deadline extensions.  ``"numpy-ref"``
must equal ``repro``'s ``"numpy-ref"``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import oracle as ref_oracle
from repro.core.knowledge import KnowledgeBase as RefKB
from repro.core.policy import learn_window as ref_learn_window
from repro.core.profiles import amdahl_profile as ref_amdahl
from repro.core.types import Job as RefJob
from repro.experiment import Scenario as RefScenario
from repro.experiment import run as ref_run
from repro_torch.core import oracle
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.policy import learn_window
from repro_torch.core.profiles import amdahl_profile
from repro_torch.core.types import Job
from repro_torch.experiment import Scenario, run
from repro_torch.kernels import oracle_greedy

WEEK = 24 * 7
SMALL = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)
MAIN = dict(region="south-australia", capacity=40, learn_weeks=3, seed=1)


def _jobs(specs):
    """The same jobs for both packages from (arrival, length, delay, k_max)."""
    ref = [RefJob(job_id=i, arrival=a, length=ln, queue=0, delay=d,
                  profile=ref_amdahl(1, km, 0.5), k_min=1)
           for i, (a, ln, d, km) in enumerate(specs)]
    port = [Job(job_id=i, arrival=a, length=ln, queue=0, delay=d,
                profile=amdahl_profile(1, km, 0.5), k_min=1)
            for i, (a, ln, d, km) in enumerate(specs)]
    return ref, port


def _assert_same(ref, res):
    for name in ("capacity_curve", "rho_curve", "work_done"):
        a, b = getattr(ref, name), getattr(res, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(ref.schedule.alloc, res.schedule.alloc)
    assert ref.schedule.alloc.dtype == res.schedule.alloc.dtype
    np.testing.assert_array_equal(ref.schedule.extended, res.schedule.extended)
    assert ref.schedule.feasible == res.schedule.feasible
    assert [j.delay for j in ref.schedule.jobs] == [j.delay for j in res.schedule.jobs]


def _both(ref_jobs, jobs, ci, capacity, horizon=None, backend=("jax", "device")):
    kw = {} if backend[1] != "device" else dict(device="cpu")
    ref = ref_oracle.solve(ref_jobs, ci, capacity, horizon=horizon,
                           backend=backend[0])
    res = oracle.solve(jobs, ci, capacity, horizon=horizon, backend=backend[1], **kw)
    _assert_same(ref, res)
    return res


@given(seed=st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_device_pass_matches_jax_random(seed):
    """``tests/test_oracle.py::test_jax_matches_numpy``'s cases."""
    rng = np.random.default_rng(seed)
    ci = rng.uniform(50, 500, 16)
    specs = [(int(rng.integers(0, 8)), float(rng.uniform(1, 3)),
              int(rng.integers(0, 6)), 3) for _ in range(4)]
    _both(*_jobs(specs), ci, 5)


def test_device_pass_extends_deadlines_as_jax():
    """``test_infeasible_extends_deadlines`` made larger: 6 jobs of length
    10 on capacity 1 with CI noise, so the retries extend and reorder."""
    rng = np.random.default_rng(5)
    ci = rng.uniform(80, 120, 90)
    ref_jobs, jobs = _jobs([(i, 10.0, 0, 1) for i in range(6)])
    res = _both(ref_jobs, jobs, ci, 1)
    assert res.schedule.extended.sum() > 0 and res.schedule.feasible


def test_device_pass_empty_job_list():
    res = _both([], [], np.full(10, 100.0), 4)
    assert res.schedule.alloc.shape == (0, 10)
    np.testing.assert_array_equal(res.rho_curve, np.ones(10))


def test_device_pass_no_entries():
    """Jobs whose window lies past the horizon give no entries: zeros, as
    the reference returns for an empty entry list, and no device pass."""
    ref_jobs, jobs = _jobs([(12, 2.0, 3, 2), (15, 1.0, 0, 1)])
    oracle.reset_stats()
    res = _both(ref_jobs, jobs, np.full(12, 50.0), 3, horizon=12)
    assert res.work_done.tolist() == [0.0, 0.0]
    assert oracle.stats["device_passes"] == 0


def _window(mat, s0=0, horizon=WEEK):
    return [dataclasses.replace(j, arrival=j.arrival - s0)
            for j in mat.hist if s0 <= j.arrival < s0 + horizon]


@pytest.mark.parametrize("capacity", [40, 3])
def test_device_pass_main_scenario_window(capacity):
    """The main scenario's first learning window (434 jobs, 205,872
    entries), and overloaded at capacity 3, where extensions retry."""
    ref_mat, mat = RefScenario(**MAIN).materialize(), Scenario(**MAIN).materialize()
    if capacity == 3:      # the overloaded case on a day's arrivals
        ref_jobs = [j for j in _window(ref_mat) if j.arrival < 24]
        jobs = [j for j in _window(mat) if j.arrival < 24]
    else:
        ref_jobs, jobs = _window(ref_mat), _window(mat)
    oracle.reset_stats()
    res = _both(ref_jobs, jobs, mat.ci.trace[:WEEK], capacity, horizon=WEEK)
    assert oracle.stats["device_passes"] >= 1
    if capacity == 40:
        assert len(jobs) == 434 and oracle.stats["entries"] == 205_872
    else:
        assert res.schedule.extended.any()


@pytest.mark.parametrize("capacity,horizon", [(8, WEEK), (3, WEEK), (8, 2 * WEEK)])
def test_numpy_ref_matches_reference(capacity, horizon):
    ref_mat, mat = RefScenario(**SMALL, eval_weeks=2).materialize(), \
        Scenario(**SMALL, eval_weeks=2).materialize()
    ref_jobs = [j for j in ref_mat.jobs if j.arrival < horizon]
    jobs = [j for j in mat.jobs if j.arrival < horizon]
    ref_jobs, jobs = ref_jobs[::3], jobs[::3]      # the reference pass is slow
    _both(ref_jobs, jobs, mat.ci.trace[:horizon], capacity, horizon=horizon,
          backend=("numpy-ref", "numpy-ref"))


def test_learn_window_device_matches_jax():
    ref_mat, mat = RefScenario(**SMALL).materialize(), Scenario(**SMALL).materialize()
    ref_kb, kb = RefKB(backend="numpy"), KnowledgeBase(device="cpu")
    ro = ref_learn_window(ref_kb, ref_mat.hist, ref_mat.ci, 0, WEEK,
                          ref_mat.cluster, backend="jax")
    po = learn_window(kb, mat.hist, mat.ci, 0, WEEK, mat.cluster, backend="device")
    _assert_same(ro.results[0], po.results[0])
    for (rs, ry), (s, y) in zip(ref_kb._windows, kb._windows, strict=True):
        np.testing.assert_array_equal(rs, s)
        np.testing.assert_array_equal(ry, y)


RUN_POLICIES = ("carbon-agnostic", "carbonflex", "oracle")


@pytest.fixture(scope="module")
def runs():
    sc = dict(SMALL, eval_weeks=2)
    ref = ref_run(RefScenario(**sc), RUN_POLICIES, backend="jax")
    oracle.reset_stats()
    oracle_greedy.reset_launches()
    port = run(Scenario(**sc), RUN_POLICIES, backend="device", device="cpu")
    return ref, port, dict(oracle.stats), dict(oracle_greedy.launches)


@pytest.mark.parametrize("name", RUN_POLICIES)
def test_run_device_backend_matches_jax(runs, name):
    """Learning phase, weekly re-learning and the oracle policy through the
    device pass: every weekly result and slot equal to ``repro``'s jax
    backend."""
    ref, port, stats, launches = runs
    assert port.kb_size == ref.kb_size > 0
    assert port.savings(name) == ref.savings(name)
    for a, b in zip(ref.weekly[name], port.weekly[name], strict=True):
        assert a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
        np.testing.assert_array_equal(a.violations, b.violations)
        np.testing.assert_array_equal(a.wait_slots, b.wait_slots)
        np.testing.assert_array_equal(a.completion, b.completion)
        assert [(s.provisioned, s.used) for s in a.slots] == \
            [(s.provisioned, s.used) for s in b.slots]
    # 1 learning window + 1 re-learning + 2 oracle weeks, no launch on the CPU
    assert stats["device_passes"] >= 4
    assert launches == {"greedy_pass": 0, "smem": 0, "l2": 0}


def test_backend_checks():
    ci = np.full(8, 100.0)
    with pytest.raises(ValueError, match="unknown oracle backend"):
        oracle.solve([], ci, 4, backend="jax")
    with pytest.raises(ValueError, match="unknown oracle backend"):
        run(Scenario(**SMALL), ("oracle",), backend="gpu", device="cpu")
    if torch.cuda.is_available():
        assert oracle.solve([], ci, 4, backend="device").work_done.shape == (0,)
    else:        # the device pass defaults to the card, like every entry point
        with pytest.raises(RuntimeError, match="no CUDA device"):
            oracle.solve([], ci, 4, backend="device")


def _packed(jobs, ci, horizon):
    """A window's entries as the device pass hands them over: packed, with
    kmin and lengths, on the CPU (the plain version)."""
    j, t, k, g, _ = oracle._build_entries(jobs, ci, horizon)
    return oracle_greedy.upload(j, t, k, g, [x.k_min for x in jobs],
                                [x.length for x in jobs], "cpu"), (j, t, k, g)


def test_plain_pass_stops_once_every_job_is_done():
    """Short jobs over a long horizon all finish: the plain pass stops
    early, reports the entries it walked, and still equals the JAX pass,
    which walks every entry."""
    rng = np.random.default_rng(2)
    ci = rng.uniform(50, 500, 48)
    ref_jobs, jobs = _jobs([(int(rng.integers(0, 10)), float(rng.uniform(1, 3)),
                             20, 3) for _ in range(6)])
    (entries, kmin, lengths), (j, t, k, g) = _packed(jobs, ci, 48)
    alloc, used, work, walked = oracle_greedy.greedy_pass(entries, kmin, lengths,
                                                          5, 48, int(k.max()))
    assert 0 < walked.item() < len(j)
    ref_alloc, ref_used, ref_work = ref_oracle._greedy_jax(
        j.astype(np.int32), t.astype(np.int32), k.astype(np.int32),
        g.astype(np.float32), kmin.numpy(), lengths.numpy(), 5, 6, 48)
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(ref_alloc))
    np.testing.assert_array_equal(used.numpy(), np.asarray(ref_used))
    np.testing.assert_array_equal(work.numpy(), np.asarray(ref_work))
    bad = entries.clone()
    bad[0, 1] = 48
    with pytest.raises(IndexError, match="outside"):
        oracle_greedy.greedy_pass(bad, kmin, lengths, 5, 48, int(k.max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_pass_on_packed_entries_matches_jax(seed):
    """The plain pass on the packed layout against ``_greedy_jax`` on the
    unpacked arrays: random windows with mixed ``k_min``, capacities that
    bind, and jobs that finish early and late."""
    rng = np.random.default_rng(seed)
    horizon = 40
    ci = rng.uniform(50, 500, horizon)
    ref_jobs = [RefJob(job_id=i, arrival=int(rng.integers(0, 30)),
                       length=float(rng.uniform(1, 8)), queue=0,
                       delay=int(rng.integers(0, 12)),
                       profile=ref_amdahl(km, km + 3, 0.3), k_min=km)
                for i, km in enumerate(rng.integers(1, 4, 12))]
    jobs = [Job(job_id=r.job_id, arrival=r.arrival, length=r.length, queue=0,
                delay=r.delay, profile=amdahl_profile(r.k_min, r.k_min + 3, 0.3),
                k_min=r.k_min) for r in ref_jobs]
    (entries, kmin, lengths), (j, t, k, g) = _packed(jobs, ci, horizon)
    for cap in (2, 6, 40):
        got = oracle_greedy.greedy_pass(entries, kmin, lengths, cap, horizon, int(k.max()))
        want = ref_oracle._greedy_jax(j.astype(np.int32), t.astype(np.int32),
                                      k.astype(np.int32), g.astype(np.float32),
                                      kmin.numpy(), lengths.numpy(), cap, len(jobs),
                                      horizon)
        for a, b in zip(got[:3], want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_packed_layout_round_trips_gain_bits():
    """Column 3 holds the float32 gain's bits: every value, subnormals,
    signed zeros, infinities and a NaN payload come back bit for bit."""
    g = np.array([0.1, 1.0, -0.0, 0.0, 1e-45, 3.4e38, np.inf, -np.inf, 0.7236],
                 np.float64)
    nan = np.array([0x7FC01234], np.int32).view(np.float32)
    g32 = np.concatenate([g.astype(np.float32), nan])
    n = len(g32)
    e = oracle_greedy.pack_entries(np.arange(n), np.arange(n) % 7, np.arange(n) + 1, g32)
    assert e.dtype == np.int32 and e.shape == (n, 4)
    np.testing.assert_array_equal(e[:, 3], g32.view(np.int32))
    np.testing.assert_array_equal(e[:, :3].T, [np.arange(n), np.arange(n) % 7,
                                               np.arange(n) + 1])
    entries, kmin, lengths = oracle_greedy.upload(
        np.arange(n), np.zeros(n), np.ones(n), g32, np.ones(3), [1.5, 2.0, 1e-9], "cpu")
    np.testing.assert_array_equal(entries.numpy()[:, 3], g32.view(np.int32))
    # float64 gains are rounded to float32 as the JAX pass casts them
    np.testing.assert_array_equal(oracle_greedy.pack_entries([0] * 9, [0] * 9, [1] * 9, g)[:, 3],
                                  g.astype(np.float32).view(np.int32))
    assert kmin.dtype == torch.int32 and kmin.tolist() == [1, 1, 1]
    assert lengths.dtype == torch.float32
    np.testing.assert_array_equal(lengths.numpy(), np.float32([1.5, 2.0, 1e-9]))


def _ragged(n, horizon, cells):
    return 65_536 + 20 * n + 4 * horizon + (max(cells, 1) + 15) // 16 * 16


# (n, horizon, k_max, cells, route, bytes): cells None is every job's
# window the whole horizon.  A row's id is its values, except for three rows
# of the table before alloc was laid out by window, whose ids (n, horizon,
# k_max, route and bytes of that dense layout) they keep.
ROUTE_TABLE = [
    ("434-168-16-smem-144328", (434, WEEK, 16, None, "smem", 147_800)),  # learning window 0
    # 923 jobs fitted the dense layout; whole-horizon windows take 8 B a job
    # more, so 883 do (below)
    ("923-168-16-smem-232356", (923, WEEK, 16, None, "l2", 65_536 + 4 * (WEEK + 3 * 923))),
    (None, (924, WEEK, 16, None, "l2", 65_536 + 4 * (WEEK + 3 * 924))),
    (None, (434, WEEK, 256, None, "l2", 65_536 + 4 * (WEEK + 3 * 434))),  # scale > a byte
    (None, (434, 552, 16, None, "l2", 65_536 + 4 * (552 + 3 * 434))),     # a whole span
    ("48-400-3-smem-86912", (48, 400, 3, None, "smem", _ragged(48, 400, 48 * 400))),
    (None, (883, WEEK, 16, None, "smem", 232_220)),   # the most whole windows that fit
    (None, (884, WEEK, 16, None, "l2", 65_536 + 4 * (WEEK + 3 * 884))),  # one job more
    (None, (434, WEEK, 16, 12_867, "smem", 87_768)),  # learning window 0 by window
    (None, (425, 552, 16, 14_223, "smem", _ragged(425, 552, 14_223))),  # week 0's span
    (None, (434, 552, 16, 14_223, "smem", _ragged(434, 552, 14_223))),
    (None, (1500, WEEK, 16, 40_000, "smem", _ragged(1500, WEEK, 40_000))),  # > 883 jobs
    (None, (425, 552, 256, 14_223, "l2", 65_536 + 4 * (552 + 3 * 425))),
    (None, (4, 10, 3, 0, "smem", _ragged(4, 10, 1))),   # no cell at all: one byte
]


@pytest.mark.parametrize("n,horizon,k_max,cells,route,nbytes", [
    pytest.param(*row, id=name or "-".join(str(x) for x in row if x is not None))
    for name, row in ROUTE_TABLE])
def test_plan_routes_by_shape(n, horizon, k_max, cells, route, nbytes):
    got = oracle_greedy.plan(n, horizon, k_max, cells)
    assert got == dict(route=route, smem_bytes=nbytes)
    assert nbytes <= oracle_greedy.SMEM_MAX
    assert oracle_greedy.smem_bytes("smem", n, horizon, cells) == \
        oracle_greedy.smem_bytes("smem", n, horizon, n * horizon if cells is None else cells)
    if route == "smem" and (n, horizon, cells) == (883, WEEK, None):
        assert oracle_greedy.smem_bytes("smem", 884, WEEK) > oracle_greedy.SMEM_MAX


def _layout_model(windows, horizon):
    """alloc laid out by window, one job after another: the clamped window
    and the position of each of its cells."""
    pos, out = 0, []
    for t0, t1 in windows:
        t0 = min(max(t0, 0), horizon)
        t1 = min(max(t1, t0), horizon)
        out.append((t0, t1, {t: pos + t - t0 for t in range(t0, t1)}))
        pos += t1 - t0
    return out, pos


@pytest.mark.parametrize("seed", range(4))
def test_ragged_layout_matches_a_python_model(seed):
    """Bases and cells against a model that lays the windows out one after
    another, with windows that start before 0, end past the horizon, are
    empty, reversed or lie wholly past the horizon."""
    rng = np.random.default_rng(seed)
    horizon = 60
    windows = np.sort(rng.integers(-10, 75, (40, 2)), axis=1)
    windows[::7] = windows[::7, ::-1]               # reversed: empty
    windows[3] = (70, 80)                           # past the horizon
    windows[5] = (12, 12)
    t0, t1, base, cells = oracle_greedy.ragged_layout(windows.astype(np.int32), horizon)
    model, total = _layout_model(windows.tolist(), horizon)
    assert cells == total
    seen = set()
    for j, (m0, m1, where) in enumerate(model):
        assert (t0[j], t1[j]) == (m0, m1)
        for t, at in where.items():
            assert base[j] + t == at and 0 <= at < cells
            seen.add(at)
    assert seen == set(range(cells))                # every byte once


def test_plain_pass_rejects_an_entry_outside_its_window():
    """Given the windows, the plain pass raises on a walked entry whose slot
    lies outside its job's window, as on one outside n x horizon; with the
    true windows its results are those of the dense pass."""
    rng = np.random.default_rng(2)
    ci = rng.uniform(50, 500, 48)
    _, jobs = _jobs([(int(rng.integers(0, 10)), float(rng.uniform(1, 3)), 20, 3)
                     for _ in range(6)])
    j, t, k, g, _ = oracle._build_entries(jobs, ci, 48)
    t0, t1, _ = oracle._windows(jobs, 48)
    args = oracle_greedy.upload(j, t, k, g, [x.k_min for x in jobs],
                                [x.length for x in jobs], "cpu",
                                windows=np.stack([t0, t1], 1))
    assert len(args) == 4 and args[3].dtype == torch.int32 and args[3].shape == (6, 2)
    cells = oracle_greedy.ragged_layout(args[3].numpy(), 48)[3]
    whole = oracle_greedy.greedy_pass(*args[:3], 5, 48, int(k.max()))
    ragged = oracle_greedy.greedy_pass(*args[:3], 5, 48, int(k.max()), windows=args[3],
                                       cells=cells)
    for a, b in zip(whole, ragged):
        assert torch.equal(a, b)
    bad = args[0].clone()
    first = int(bad[0, 0])
    bad[0, 1] = int(t1[first])                      # one past its job's window
    with pytest.raises(IndexError, match="window"):
        oracle_greedy.greedy_pass(bad, *args[1:3], 5, 48, int(k.max()), windows=args[3],
                                  cells=cells)
    oracle_greedy.greedy_pass(bad, *args[1:3], 5, 48, int(k.max()))   # whole horizon
    with pytest.raises(ValueError, match="come together"):
        oracle_greedy.greedy_pass(*args[:3], 5, 48, int(k.max()), windows=args[3])


def test_upload_packs_the_span_windows_of_the_entries(monkeypatch):
    """The oracle policy's span on the main scenario's evaluation week 0, as
    ``OraclePolicy`` solves it: the windows ``upload`` packs are the min and
    max + 1 of each job's entry slots, and with their cells the 552-slot
    span plans the smem route (its dense alloc plans l2)."""
    from repro_torch.core.policy import OraclePolicy
    from repro_torch.core.simulator import pack

    mat = Scenario(**MAIN, eval_weeks=6).materialize()
    seen = []
    upload = oracle_greedy.upload

    def kept(j, t, k, g, kmin, lengths, device, windows=None):
        seen.append((j, t, k, windows))
        return upload(j, t, k, g, kmin, lengths, device, windows=windows)

    monkeypatch.setattr(oracle_greedy, "upload", kept)
    jobs = pack(mat.eval_week(0)).jobs
    OraclePolicy(backend="device", device="cpu").on_window_start(
        mat.ci, mat.t0, WEEK, jobs, mat.cluster)
    j, t, k, windows = seen[0]
    span = 552
    assert len(jobs) == windows.shape[0] == 425 and len(j) == 227_568
    lo = np.full(len(jobs), np.iinfo(np.int64).max)
    hi = np.full(len(jobs), -1)
    np.minimum.at(lo, j, t)
    np.maximum.at(hi, j, t)
    has = hi >= 0
    np.testing.assert_array_equal(windows[has, 0], lo[has])
    np.testing.assert_array_equal(windows[has, 1], hi[has] + 1)
    cells = oracle_greedy.ragged_layout(windows, span)[3]
    assert cells == 14_223
    assert oracle_greedy.plan(len(jobs), span, int(k.max()), cells)["route"] == "smem"
    assert oracle_greedy.plan(len(jobs), span, int(k.max()))["route"] == "l2"


def test_plan_rejects_what_no_route_holds():
    with pytest.raises(ValueError, match="shared memory"):
        oracle_greedy.plan(434, 60_000, 16)
    with pytest.raises(ValueError, match="unknown greedy route"):
        oracle_greedy.smem_bytes("hbm", 4, 4)
    with pytest.raises(ValueError, match="unknown greedy route"):
        oracle_greedy.greedy_pass(*_packed(*_jobs([(0, 1.0, 0, 1)])[1:], np.ones(4), 4)[0],
                                  1, 4, 1, route="hbm")


def test_kernel_constants_match_the_cuda_source():
    """The plan's constants and byte counts are those the kernel's source
    declares (the card test also compares the library's byte counts)."""
    import re
    from pathlib import Path

    src = (Path(oracle_greedy.__file__).resolve().parents[1] / "csrc"
           / "oracle_greedy.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(const["STAGE"]) == oracle_greedy.STAGE
    assert int(const["SCALE_MAX"]) == oracle_greedy.SCALE_MAX
    assert const["SMEM_MAX"].split("//")[0].strip() == "232448 - 64"
    assert oracle_greedy.SMEM_MAX == 232448 - 64
    assert "20LL * n + 4LL * horizon +" in src and "round16(cells > 0 ? cells : 1)" in src
    assert "4LL * (horizon + 3LL * n)" in src
    assert oracle_greedy.ROUTES.index("smem") == int(const["ROUTE_SMEM"])
    assert oracle_greedy.ROUTES.index("l2") == int(const["ROUTE_L2"])
