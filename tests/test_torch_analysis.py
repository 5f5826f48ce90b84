"""The port's run-time guardrails (``fedml_tpu_torch/analysis``: the race
sanitizer over the lock factories, the runtime auditor at
``end_of_round_sync``) and the compile watcher
(``observability/compilemon.py``) against the reference.

- The reference's race-audit scenarios (``tests/test_analysis.py``
  ``TestRaceAudit``) retargeted at the port, and the lock identity the
  port's auditor reports equal to the one the reference's static pass
  derives for the same source.
- Counterparts of the reference's ``TestRuntimeAuditor`` with the same
  asserts. The port's compile events are the builds and loads of its
  kernel libraries (``ops/_build.py``), so a "retrace" here is a library
  loaded in a round: the scenarios load a stand-in library, built from a
  trivial C source by a stand-in compiler in ``tmp_path`` that calls
  ``g++`` in place of ``nvcc``, through ``_build.py``'s own path (a
  wrapper's first ``.lib``, or ``build_all``).
- The watcher's hit/miss split through the same path.

Skipped where there is no ``g++`` (the cases that build)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import ast
import dataclasses
import importlib.util
import os
import shutil
import stat
import types

import numpy as np
import pytest
import torch

from reference_scenarios import retarget_defs

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_classification_spec
from fedml_tpu_torch.analysis import audit, current_auditor
from fedml_tpu_torch.data.synthetic import load_synthetic_federated
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.observability import MetricsRegistry, set_registry
from fedml_tpu_torch.observability.compilemon import watch_compiles
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops._build import CudaLibrary
from fedml_tpu_torch.utils.profiling import end_of_round_sync, off_round_work

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the stand-in compiler calls g++")

# -- the reference's race-audit scenarios, through the port -------------------
TestRaceAudit = retarget_defs("test_analysis.py",
                              ["TestRaceAudit"]).TestRaceAudit


def test_the_retargeted_scenarios_run_the_port():
    names = set()
    for name in dir(TestRaceAudit):
        if name.startswith("test_"):
            names |= set(getattr(TestRaceAudit, name).__code__.co_names)
    assert {"fedml_tpu_torch.analysis", "fedml_tpu_torch.analysis.locks",
            "fedml_tpu_torch.core.comm"} <= names
    assert not any(n.startswith("fedml_tpu.") for n in names)


def test_lock_identity_equals_the_reference_static_site(tmp_path):
    """The port's auditor names a lock by its creation site, the same
    string the reference's static pass derives from the source."""
    from fedml_tpu.analysis.crossclass import CrossClassIndex
    from fedml_tpu_torch.analysis.runtime import race_audit

    src = ("from fedml_tpu_torch.core.locks import audited_lock\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = audited_lock()\n")
    mod_file = tmp_path / "idmod.py"
    mod_file.write_text(src)
    index = CrossClassIndex()
    index.add_module(str(mod_file),
                     ast.parse(src.replace("fedml_tpu_torch.", "fedml_tpu.")))
    cls = next(iter(index.modules.values()))["classes"]["C"]
    static_site = cls.families["_lock"][1]
    assert static_site == "idmod.py:4"
    spec = importlib.util.spec_from_file_location("idmod", str(mod_file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with race_audit() as ra:
        inst = mod.C()
    assert inst._lock.site == static_site
    assert ra.locks_created == 1


# -- a stand-in kernel library ------------------------------------------------
NVCC = """#!/bin/sh
# stand-in for nvcc: the output after -o, the source last; a ptxas-like
# report on stderr
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"; src="$a"
done
echo "ptxas info    : Used 1 registers" >&2
exec g++ -shared -fPIC -x c++ -o "$out" "$src"
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """``make(name)`` -> a fresh ``CudaLibrary`` object of a trivial C
    source ``csrc/<name>.cu``, built by the stand-in compiler into
    ``tmp_path/build`` (the process-wide build directory for the test).
    Two objects of one name are two processes' views of one build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_build_dir", str(tmp_path / "build"))

    def make(name):
        src = csrc / f"{name}.cu"
        if not src.exists():
            src.write_text(f'extern "C" int {name}_probe(void) '
                           '{ return 7; }\n')
        return CudaLibrary(name, bind=lambda lib: None, csrc=str(csrc))

    return make


# -- the runtime auditor (counterparts of the reference's TestRuntimeAuditor)
def _args(**kw):
    base = dict(client_num_in_total=2, client_num_per_round=2, comm_round=2,
                epochs=1, batch_size=16, lr=0.3, client_optimizer="sgd",
                wd=0.0, frequency_of_the_test=100, ci=0, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _dataset():
    return load_synthetic_federated(client_num=2, n_train=80, n_test=20,
                                    alpha=0.0, beta=0.0, seed=0)


def _spec(launch=None):
    """LR's spec; ``launch()`` runs before every training step,
    as a kernel wrapper's first launch loads its library."""
    spec = make_classification_spec(
        LogisticRegression(60, 10, apply_sigmoid=False))
    if launch is None:
        return spec
    inner = spec.stacked_loss_fn

    def stacked_loss_fn(*a, **kw):
        launch()
        return inner(*a, **kw)

    return dataclasses.replace(spec, stacked_loss_fn=stacked_loss_fn)


@needs_gxx
class TestRuntimeAuditor:
    def test_healthy_two_round_fedavg_no_steady_state_retraces(
            self, stand_in):
        lib = stand_in("kern")
        api = FedAvgAPI(_dataset(), _spec(lambda: lib.lib), _args(),
                        device="cpu")
        with audit() as auditor:
            api.train_one_round()
            api.train_one_round()
        report = auditor.report()
        assert report["audit/rounds"] == 2
        assert len(report["audit/retraces_per_round"]) == 2
        assert report["audit/retraces_per_round"][0] > 0  # the first load
        assert report["audit/compiles_per_round"] == [1, 0]
        assert report["audit/steady_state_retraces"] == 0
        assert report["audit/transfer_guard_violations"] == 0

    def test_detects_intentional_retrace(self, stand_in):
        # a library first launched in round 2 loads there: the auditor
        # must see it in round 2's bucket
        first, late = stand_in("kern"), stand_in("late")
        holder = {}

        def launch():
            first.lib
            if holder["api"].round_idx == 1:
                late.lib

        api = FedAvgAPI(_dataset(), _spec(launch), _args(), device="cpu")
        holder["api"] = api
        with audit() as auditor:
            api.train_one_round()
            api.train_one_round()
        assert auditor.retraces_per_round[1] > 0
        assert auditor.report()["audit/steady_state_retraces"] > 0

    def test_report_goes_to_metrics_logger(self, stand_in):
        records = []
        with audit(metrics_logger=records.append) as auditor:
            stand_in("kern").build()
            auditor.mark_round()
        assert len(records) == 1
        assert records[0]["audit/rounds"] == 1
        assert records[0]["audit/retraces_per_round"][0] > 0

    def test_midrun_eval_does_not_pollute_round_buckets(self, stand_in):
        # eval runs between round syncs (frequency_of_the_test=1 fires it
        # after every round): its first load is booked as trailing, not
        # as a phantom load in the next round's bucket
        lib = stand_in("evalkern")
        api = FedAvgAPI(_dataset(), _spec(), _args(frequency_of_the_test=1),
                        device="cpu")
        inner = api.eval_fn

        def eval_fn(*a):
            lib.lib
            return inner(*a)

        api.eval_fn = eval_fn
        with audit() as auditor:
            api.train()
        report = auditor.report()
        assert report["audit/rounds"] == 2
        assert report["audit/steady_state_retraces"] == 0
        assert report["audit/trailing_traces"] > 0  # the eval's load
        assert report["audit/transfer_guard_violations"] == 0

    def test_audit_reads_the_run_watcher(self, stand_in):
        """Inside a compile watcher the audit joins it (one tally of the
        build events), and a load between rounds is booked in neither's
        round buckets."""
        lib = stand_in("kern")
        with watch_compiles() as w:
            with audit() as auditor:
                assert auditor.watcher is w
                end_of_round_sync(torch.ones(1))
                with off_round_work():
                    lib.lib
                end_of_round_sync(torch.ones(1))
        report = auditor.report()
        assert report["audit/retraces_per_round"] == [0, 0]
        assert w.report()["compile/traces_per_round"] == [0, 0]
        assert report["audit/trailing_traces"] == w.off_round_traces == 1
        assert w.cache_misses == 1

    def test_trailing_activity_reported_separately(self, stand_in):
        with audit() as auditor:
            end_of_round_sync(torch.ones(3))
            stand_in("kern").build()
        report = auditor.report()
        assert report["audit/rounds"] == 1
        assert report["audit/trailing_traces"] > 0
        # post-round work (final eval, teardown) is not a round's
        assert report["audit/steady_state_retraces"] == 0


def test_transfer_guard_violation_counted_not_raised():
    # a state leaf off the run's device at the end-of-round sync
    state = {"params": {"w": torch.ones(4), "b": torch.empty(4,
                                                             device="meta")}}
    with audit() as auditor:
        end_of_round_sync(state, torch.device("cpu"))
    assert auditor.transfer_guard_violations == 1
    # a host array is on the host: no violation on the CPU
    with audit() as auditor:
        end_of_round_sync({"w": np.ones(4)}, torch.device("cpu"))
    assert auditor.transfer_guard_violations == 0


def test_disabled_audit_yields_none():
    with audit(enabled=False) as auditor:
        assert auditor is None
    assert current_auditor() is None


def test_end_of_round_sync_without_auditor():
    state = {"w": torch.ones(3) * 2}
    assert end_of_round_sync(state) is state


def test_end_of_round_sync_marks_rounds_on_active_auditor():
    with audit() as auditor:
        end_of_round_sync(torch.ones(3))
        end_of_round_sync(torch.ones(3))
    assert auditor.rounds == 2


def test_off_round_work_without_auditor_is_noop():
    with off_round_work():
        pass
    assert current_auditor() is None


def test_nested_audit_restores_outer():
    with audit() as outer:
        with audit() as inner:
            assert current_auditor() is inner
        assert current_auditor() is outer
    assert current_auditor() is None


def test_healthy_cpu_run_books_nothing():
    """On the CPU the wrappers run their plain versions: a whole run
    loads no library, and every bucket is 0."""
    api = FedAvgAPI(_dataset(), _spec(), _args(), device="cpu")
    with audit() as auditor:
        api.train()
    report = auditor.report()
    assert report["audit/retraces_per_round"] == [0, 0]
    assert report["audit/compiles_per_round"] == [0, 0]


# -- the compile watcher ------------------------------------------------------
@needs_gxx
def test_watcher_splits_builds_and_loads_into_misses_and_hits(stand_in):
    """A library built by the (stand-in) compiler is a miss with its
    seconds; the same library loaded by a fresh process (a fresh
    ``CudaLibrary``) from the build directory is a hit; both the
    wrapper's first ``.lib`` and ``build_all`` are seen, bucketed per
    round, with the port's registry names."""
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        with watch_compiles() as w:
            stand_in("kern").lib          # a wrapper's first launch
            end_of_round_sync(torch.ones(1))
            _build.build_all([stand_in("kern"), stand_in("other")])
            end_of_round_sync(torch.ones(1))
            stand_in("other").lib
    finally:
        set_registry(prev)
    assert w.cache_misses == 2 and w.cache_hits == 2
    rep = w.report()
    assert rep["compile/compiles_per_round"] == [1, 1]
    assert rep["compile/traces_per_round"] == [1, 2]
    assert rep["compile/total_traces"] == 4  # the last load is trailing
    assert rep["compile/total_seconds"] > 0
    assert all(s > 0 for s in rep["compile/seconds_per_round"])
    assert reg.get("kernel_builds_total") == 2
    assert reg.get("kernel_loads_total", cached="true") == 2
    assert reg.get("kernel_loads_total", cached="false") == 2
    # each built library keeps its compiler report beside it
    assert all(os.path.exists(p + ".log") for p in
               (stand_in("kern").path(), stand_in("other").path()))


@needs_gxx
def test_a_moved_build_directory_is_a_miss_then_a_hit(stand_in, tmp_path):
    """``set_build_dir`` (``--compile_cache_dir``) moves where libraries
    are built and looked for: the first process over a new directory
    builds, the next loads."""
    stand_in("kern").build()
    prev = _build.set_build_dir(str(tmp_path / "cache"))
    try:
        with watch_compiles() as cold:
            stand_in("kern").build()
        with watch_compiles() as warm:
            stand_in("kern").build()
    finally:
        _build.set_build_dir(prev)
    assert (cold.cache_misses, cold.cache_hits) == (1, 0)
    assert (warm.cache_misses, warm.cache_hits) == (0, 1)
    assert os.listdir(tmp_path / "cache")
