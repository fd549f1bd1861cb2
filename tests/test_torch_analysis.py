"""The port's static analysis (``repro_torch.analysis``) against the
reference's tests (``tests/test_analysis.py``), twin for twin.

* **hamlint** — the corpus ``tests/fixtures/hamlint_bad_torch/`` (the
  reference's fixtures importing ``repro_torch``, plus the torch idioms
  HAM001 must know: in-place methods and functions, views, methods that may
  return their receiver, ``torch.from_numpy`` of a ``deref``) seeds each
  rule's violations; each fires at its exact file:line, the corpus is fully
  accounted for, ``src/repro_torch`` is clean with zero suppressions, and
  the port's ``register()`` rejects at call time what is cheap to check.
* **modelcheck** — the mitigated models, built from the port's
  ``comm.shm`` and ``comm.doorbell`` constants, verify; each broken variant
  rediscovers its historical bug (PR 1 torn counter, PR 7 lost wakeups)
  within the reference's 5 s.
* **against the reference** — on the same inputs the port and
  ``repro.analysis`` report the same findings (rule, file, line, column,
  message; HAM004 names its own canonical module), and the models of the
  ``--quick`` gate explore the same states and find the same violations
  along the same traces.
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from repro.analysis import modelcheck as reference_modelcheck
from repro.analysis.hamlint import lint_paths as reference_lint_paths
from repro_torch.analysis import modelcheck
from repro_torch.analysis.hamlint import lint_paths, main as hamlint_main
from repro_torch.analysis.modelcheck import explore, main as modelcheck_main
from repro_torch.analysis.models.doorbell import DoorbellModel
from repro_torch.analysis.models.ring_counters import RingCounterModel
from repro_torch.core.errors import RegistryError
from repro_torch.core.migratable import ArraySpec, ScalarSpec
from repro_torch.core.registry import HandlerRegistry

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "hamlint_bad_torch"
REFERENCE_FIXTURES = REPO / "tests" / "fixtures" / "hamlint_bad"
SRC = REPO / "src" / "repro_torch"


def _line_of(path: Path, needle: str) -> int:
    """1-based line number of the unique line containing ``needle``."""
    hits = [
        i
        for i, line in enumerate(path.read_text().splitlines(), start=1)
        if needle in line
    ]
    assert len(hits) == 1, f"{needle!r} not unique in {path}: {hits}"
    return hits[0]


@pytest.fixture(scope="module")
def fixture_findings():
    return lint_paths([str(FIXTURES)])


def _expect(findings, rule: str, filename: str, line: int):
    """Assert exactly one finding of ``rule`` at ``filename:line``."""
    matches = [
        f
        for f in findings
        if f.rule == rule and Path(f.path).name == filename and f.line == line
    ]
    assert len(matches) == 1, (
        f"expected one {rule} at {filename}:{line}, got "
        f"{[g.format() for g in findings]}"
    )
    return matches[0]


# ---------------------------------------------------------------------------
# hamlint: each rule fires on its fixture at the right location


def test_readonly_purity_catches_inplace_mutation(fixture_findings):
    line = _line_of(FIXTURES / "bad_readonly.py", "y += alpha")
    f = _expect(fixture_findings, "HAM001", "bad_readonly.py", line)
    assert "read_only=True" in f.message
    assert f"line {line}" in f.message  # names the offending store


def test_readonly_purity_catches_store_through_view(fixture_findings):
    line = _line_of(FIXTURES / "bad_readonly.py", "row[:] = 0.0")
    f = _expect(fixture_findings, "HAM001", "bad_readonly.py", line)
    assert "row" in f.message


def test_readonly_purity_catches_alias_escape(fixture_findings):
    line = _line_of(FIXTURES / "bad_readonly.py", '_stash["x"]')
    f = _expect(fixture_findings, "HAM001", "bad_readonly.py", line)
    assert "alias escape" in f.message


def test_undeclared_mutation_names_the_mutates_fix(fixture_findings):
    line = _line_of(FIXTURES / "bad_undeclared_mutation.py", "y *= alpha")
    f = _expect(fixture_findings, "HAM001", "bad_undeclared_mutation.py", line)
    # the finding must NAME the fix, not just the defect
    assert "mutates=True" in f.message
    assert "read_only=True but" not in f.message  # not the PR 5 wording


def test_declared_mutates_inplace_store_is_legal(fixture_findings):
    """A mutates=True handler's in-place store is the point of the
    annotation — zero findings anywhere in its fixture."""
    assert not [
        f for f in fixture_findings
        if Path(f.path).name == "ok_mutates.py"
    ]


def test_spec_coherence_catches_arity_mismatch(fixture_findings):
    # the finding anchors on the register() call that follows this comment
    line = _line_of(FIXTURES / "bad_arity.py", "# three leaves") + 1
    f = _expect(fixture_findings, "HAM002", "bad_arity.py", line)
    assert "3 leaves" in f.message and "2 positional" in f.message


def test_spec_coherence_catches_bad_scalar_kind(fixture_findings):
    line = _line_of(FIXTURES / "bad_arity.py", 'ScalarSpec("u4")')
    f = _expect(fixture_findings, "HAM002", "bad_arity.py", line)
    assert "'u4'" in f.message


def test_same_source_catches_foreign_registration(fixture_findings):
    line = _line_of(FIXTURES / "bad_unreachable.py", 'name="bad/foreign_fn"')
    f = _expect(fixture_findings, "HAM003", "bad_unreachable.py", line)
    assert "_bad_unreachable_helper" in f.message


def test_same_source_catches_never_at_import(fixture_findings):
    line = _line_of(FIXTURES / "bad_unreachable.py", 'name="bad/never_at_import"')
    f = _expect(fixture_findings, "HAM003", "bad_unreachable.py", line)
    assert "never executes at import" in f.message


def test_wire_constants_catches_collision_and_live_sentinel(fixture_findings):
    """HAM004 holds the port's own table (``repro_torch.core.flags``)."""
    line = _line_of(FIXTURES / "bad_flags.py", "FLAG_EXPERIMENTAL")
    f = _expect(fixture_findings, "HAM004", "bad_flags.py", line)
    assert "collides with FLAG_STATIC" in f.message
    assert "repro_torch.core.flags" in f.message
    line = _line_of(FIXTURES / "bad_flags.py", "MSG_ID_DRAIN")
    f = _expect(fixture_findings, "HAM004", "bad_flags.py", line)
    assert "INSIDE live msg_id space" in f.message


# (marker on the line, what the message names) for each torch idiom of
# bad_torch_idioms.py; all but the last are declared read_only=True
TORCH_IDIOMS = [
    ("# trailing-underscore method", "'.copy_()'"),
    ("# in-place inside a return", "'.zero_()'"),
    ("# write through a narrow view", "'head'"),
    ("# store through a select view", "'row'"),
    ("# detach() aliases its receiver", "'.mul_()'"),
    ("# contiguous() may return self", "contiguous()"),
    ("# from_numpy shares the memory", "'t'"),
    ("# in-place free function", "'normal_'"),
    ("# chunk() returns views", "'hi'"),
    ("# inplace=True", "inplace=True"),
    ("# undeclared in-place write", "'.index_put_()'"),
]


TORCH_IDIOM_IDS = ["copy_", "zero_returned", "narrow", "select", "detach", "contiguous",
                   "from_numpy", "init_normal_", "chunk", "relu_inplace", "undeclared_index_put_"]


@pytest.mark.parametrize("marker,named", TORCH_IDIOMS, ids=TORCH_IDIOM_IDS)
def test_readonly_purity_catches_torch_idiom(fixture_findings, marker, named):
    line = _line_of(FIXTURES / "bad_torch_idioms.py", marker)
    f = _expect(fixture_findings, "HAM001", "bad_torch_idioms.py", line)
    assert named in f.message
    if marker == "# undeclared in-place write":
        assert "declare mutates=True" in f.message
    else:
        assert "read_only=True but" in f.message


def test_torch_reads_and_declared_add_are_legal(fixture_findings):
    """``mutates=True`` + ``add_`` is the declared-write edge; out-of-place
    ops, writes into copies and locals, and metadata store nothing."""
    assert not [f for f in fixture_findings if Path(f.path).name == "ok_torch.py"]


def test_reference_linter_misses_the_torch_idioms():
    """Why the port's HAM001 is more than a rename: the reference's rule
    knows only numpy's ways of writing and aliasing, and passes every torch
    idiom above."""
    findings = reference_lint_paths([str(FIXTURES / "bad_torch_idioms.py")])
    assert findings == []


def test_fixture_corpus_is_fully_accounted_for(fixture_findings):
    """Every fixture finding is one the tests above asserted — a rule that
    starts over- or under-firing on the corpus fails here."""
    by_rule = sorted(f.rule for f in fixture_findings)
    assert by_rule == [
        *["HAM001"] * (4 + len(TORCH_IDIOMS)),
        "HAM002", "HAM002",
        "HAM003", "HAM003",
        "HAM004", "HAM004",
    ]


def _as_the_reference_reports(findings):
    """(rule, file, line, column, message), the port's HAM004 canonical
    module named as the reference names its own."""
    return sorted(
        (f.rule, Path(f.path).name, f.line, f.col,
         f.message.replace("repro_torch.core.flags", "repro.core.flags"))
        for f in findings
    )


@pytest.mark.parametrize("corpus", ["reference_fixtures", "torch_twins"])
def test_findings_equal_the_reference_linters(corpus):
    """The reference's corpus, and its seven twins in the torch corpus
    (``repro`` imports rewritten to ``repro_torch``), linted by both."""
    if corpus == "reference_fixtures":
        paths = [str(REFERENCE_FIXTURES)]
    else:
        paths = [str(FIXTURES / p.name) for p in sorted(REFERENCE_FIXTURES.glob("*.py"))]
    port = _as_the_reference_reports(lint_paths(paths))
    assert port == _as_the_reference_reports(reference_lint_paths(paths))
    assert sorted(f[0] for f in port) == ["HAM001"] * 4 + ["HAM002"] * 2 + ["HAM003"] * 2 + [
        "HAM004"] * 2


def test_live_tree_is_clean_with_zero_suppressions():
    findings = lint_paths([str(SRC)])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_exit_codes(capsys):
    assert hamlint_main([str(SRC)]) == 0
    assert hamlint_main([str(FIXTURES)]) == 1
    out = capsys.readouterr().out
    # CLI output is file:line:col: RULE message
    assert "bad_readonly.py:" in out and "HAM001" in out
    assert "bad_torch_idioms.py:" in out
    assert hamlint_main([]) == 2
    assert hamlint_main(["--bogus", str(SRC)]) == 2


# ---------------------------------------------------------------------------
# register(): the cheap subset of hamlint, enforced at call time


def test_register_rejects_arity_mismatch():
    reg = HandlerRegistry()

    def takes_two(a, b):
        return a

    with pytest.raises(RegistryError, match="hamlint"):
        reg.register(
            takes_two,
            arg_specs=(ScalarSpec("i8"), ScalarSpec("i8"), ScalarSpec("f8")),
            name="t/arity",
        )


def test_register_rejects_uncompilable_specs():
    reg = HandlerRegistry()

    def takes_one(a):
        return a

    with pytest.raises(RegistryError, match="t/kind"):
        reg.register(takes_one, arg_specs=(ScalarSpec("u4"),), name="t/kind")


def test_register_accepts_valid_specs():
    reg = HandlerRegistry()

    def saxpy(a, x, y):
        return y

    rec = reg.register(
        saxpy,
        arg_specs=(
            ScalarSpec("f8"),
            ArraySpec((4,), "float32"),
            ArraySpec((4,), "float32"),
        ),
        name="t/ok",
    )
    assert rec.stable_name.startswith("t/ok")


# ---------------------------------------------------------------------------
# modelcheck: mitigated protocols verify, broken variants rediscover bugs


def test_ring_counters_mitigated_verifies():
    result = explore(RingCounterModel(publishes=2, mitigated=True))
    assert result.ok, result.describe()
    assert result.states > 100  # exhaustive, not a trivial walk


def test_ring_counters_broken_rediscovers_pr1_torn_read():
    start = time.monotonic()
    result = explore(RingCounterModel(publishes=2, mitigated=False))
    assert time.monotonic() - start < 5.0
    assert not result.ok
    assert "torn counter" in result.violation
    # the counterexample is the historical race: a raw read split across a
    # writer's two half-word stores fabricates a never-published value
    assert any("accept raw primary" in step for step in result.trace)


def test_doorbell_mitigated_verifies():
    result = explore(DoorbellModel(producers=2, items=1))
    assert result.ok, result.describe()


def test_doorbell_no_repoll_rediscovers_lost_wakeup():
    start = time.monotonic()
    result = explore(DoorbellModel(producers=1, items=1, repoll=False))
    assert time.monotonic() - start < 5.0
    assert not result.ok
    assert "lost wakeup" in result.violation
    assert any("FUTEX_WAIT parks" in step for step in result.trace)


def test_doorbell_no_seq_check_rediscovers_lost_wakeup():
    result = explore(DoorbellModel(producers=1, items=1, seq_check=False))
    assert not result.ok
    assert "lost wakeup" in result.violation


def test_doorbell_model_tracks_implementation_step_order(monkeypatch):
    """The model builds its consumer from the port's CONSUMER_PARK_PROTOCOL,
    so an implementation reorder (snapshotting seq AFTER the re-poll — a
    real lost-wakeup window) is model-checked, not assumed away."""
    import repro_torch.analysis.models.doorbell as model_mod

    monkeypatch.setattr(
        model_mod,
        "CONSUMER_PARK_PROTOCOL",
        ("arm", "repoll", "read_seq", "wait_if_unchanged"),
    )
    result = explore(DoorbellModel(producers=1, items=1))
    assert not result.ok
    assert "lost wakeup" in result.violation


def test_models_read_the_ports_protocol_constants():
    """The models import their layout and step orders from the port's
    fabrics, and those equal the reference's."""
    import repro.analysis.models.doorbell as ref_doorbell
    import repro.analysis.models.ring_counters as ref_ring
    import repro_torch.analysis.models.doorbell as doorbell
    import repro_torch.analysis.models.ring_counters as ring
    import repro_torch.comm.doorbell as port_doorbell
    import repro_torch.comm.shm as port_shm

    for name in ("COUNTER_LOAD_ORDER", "COUNTER_STORE_ORDER", "COUNTER_STABLE_RETRIES",
                 "HEAD_OFF", "HEAD_CONFIRM_OFF", "COUNTER_CONFIRM_STRIDE"):
        assert getattr(ring, name) is getattr(port_shm, name)
        assert getattr(ring, name) == getattr(ref_ring, name)
    for name in ("CONSUMER_PARK_PROTOCOL", "PRODUCER_RING_PROTOCOL", "SEQ_OFF", "WAITERS_OFF"):
        assert getattr(doorbell, name) is getattr(port_doorbell, name)
        assert getattr(doorbell, name) == getattr(ref_doorbell, name)


def test_modelcheck_cli_quick_gate(capsys):
    start = time.monotonic()
    assert modelcheck_main(["--quick"]) == 0
    assert time.monotonic() - start < 5.0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 5


@pytest.mark.parametrize("case", range(5), ids=["ring_mitigated", "ring_broken",
                                                "doorbell_mitigated", "doorbell_no_repoll",
                                                "doorbell_no_seq_check"])
def test_quick_models_explore_the_references_states(case):
    """Each ``--quick`` configuration, the port's model against the
    reference's: the same verdict, state count, violation and trace."""
    desc, model, expect_ok = modelcheck._suite(quick=True)[case]
    ref_desc, ref_model, ref_expect_ok = reference_modelcheck._suite(quick=True)[case]
    assert (desc, expect_ok) == (ref_desc, ref_expect_ok)
    got, want = explore(model), reference_modelcheck.explore(ref_model)
    assert got.ok is expect_ok
    assert (got.ok, got.states, got.violation, got.trace) == (
        want.ok, want.states, want.violation, want.trace)
