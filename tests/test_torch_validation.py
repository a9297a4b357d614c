"""The port's acceptance programs against the JAX ones, on the CPU.

* ``quantum_simulator_tpu_torch.validation`` against the repository's
  ``test_validation.py`` (run in-process once, its counters reset and its
  lines captured), group by group: the same 33 names in the same order,
  every assertion but the four ``[perf]`` ones passing on both sides (the
  ``[perf]`` bounds are compared by name only here, as the JAX harness
  notes its own flake under load; on the card they must pass), and the
  deterministic numbers within 1e-5 (the Bell amplitudes, the mutual
  information and entropy, both 2-qubit readout transforms); both ensemble
  purities < 0.9999 and traces within 1e-3 of 1.
* the parity twin's ``run_ours(200, "cpu")`` against the JAX script's
  ``run_ours(200)`` through the script's own ``compare`` (amplitudes 1e-6,
  readout 1e-9, 4-sigma Monte-Carlo bands, TVD 0.02): all 8 checks pass.
  Without a reference checkout (no ``--reference``, or a directory with
  no ``quantum_sim``) the twin exits 2; the reference subprocess sees only
  the named checkout and writes no bytecode there.
* the latency twin at n = 6, depth 2: the JAX script's keys less the ones
  it drops, ``INTERACTIVE_r05.json`` untouched, and ``--output`` the only
  file written.
* without a card and without ``--device`` each of the three exits non-zero
  before any work, and none imports JAX, the JAX package or ``scripts/``.
"""

import ast
import contextlib
import importlib.util
import io
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import test_validation as jv
from quantum_simulator_tpu_torch import validation
from quantum_simulator_tpu_torch.ops import plan as tplan
from quantum_simulator_tpu_torch.ops import program as tprog
from quantum_simulator_tpu_torch.scripts import (interactive_latency_check,
                                                 parity_check)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LINE = re.compile(r"^  \[(PASS|FAIL)\] (.*?)(?:  \((.*)\))?$")
GROUP = re.compile(r"^Group (\d+): ")
DETAIL_TOL = 1e-5
TWINS = (validation, parity_check, interactive_latency_check)


def parse_lines(text: str) -> list[tuple[int, bool, str, str]]:
    """(group, passed, name, detail) for every assertion line."""
    rows, group = [], 0
    for line in text.splitlines():
        if m := GROUP.match(line):
            group = int(m.group(1))
        elif m := LINE.match(line):
            rows.append((group, m.group(1) == "PASS", m.group(2),
                         m.group(3) or ""))
    return rows


def detail_value(detail: str, key: str) -> float:
    return float(re.search(rf"{key}=([-\d.]+)", detail).group(1))


@pytest.fixture(scope="module")
def jax_rows():
    jv.PASS = jv.FAIL = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with pytest.raises(SystemExit):
            jv.main()
    rows = parse_lines(buf.getvalue())
    assert len(rows) == validation.N_ASSERTIONS
    return rows


@pytest.fixture(scope="module")
def twin_records():
    records = validation.run_groups("cpu")
    assert len(records) == validation.N_ASSERTIONS
    return records


def _by_name(records, group):
    return {r.name: r for r in records if r.group == group}


@pytest.mark.parametrize("group", range(1, 10))
def test_harness_group_matches_jax(jax_rows, twin_records, group):
    jrows = [r for r in jax_rows if r[0] == group]
    trows = [r for r in twin_records if r.group == group]
    assert [r[2] for r in jrows] == [r.name for r in trows]
    for (_, jok, name, _), rec in zip(jrows, trows):
        if not name.startswith("[perf]"):
            assert jok and rec.ok, (name, jok, rec.ok, rec.detail)
    twin = _by_name(twin_records, group)
    jdetail = {r[2]: r[3] for r in jrows}
    if group == 1:
        want = jv.Simulator().run(jv.bell_circuit(), shots=0,
                                  seed=42).final_state.data
        got = twin["amplitudes 1/sqrt(2) at |00>,|11>"].values["amps"]
        assert np.max(np.abs(got - want)) <= DETAIL_TOL
        mi = twin["I(0:1) = 2 bits"].values["mi"]
        assert abs(mi - detail_value(jdetail["I(0:1) = 2 bits"], "mi")) \
            <= DETAIL_TOL
        s0 = twin["S(q0) = 1 bit"].values["S"]
        assert abs(s0 - detail_value(jdetail["S(q0) = 1 bit"], "S")) \
            <= DETAIL_TOL
    elif group in (4, 9):
        ro, probs, name = (
            (jv.ReadoutError(0.05, 0.05), [0.4, 0.3, 0.2, 0.1],
             "2q distribution transform matches kron to 1e-12")
            if group == 4 else
            (jv.ReadoutError(0.02, 0.02), [0.5, 0.25, 0.15, 0.1],
             "2q transform matches brute-force kron < 1e-12"))
        want = np.asarray(ro.apply_to_distribution(np.array(probs), 2))
        got = twin[name].values["transform"]
        assert np.max(np.abs(got - want)) <= DETAIL_TOL
    elif group == 8:
        jpurity = detail_value(jdetail["ensemble purity < 1 under noise"],
                               "purity")
        assert jpurity < 0.9999
        assert twin["ensemble purity < 1 under noise"].values["purity"] \
            < 0.9999
        assert abs(twin["ensemble trace = 1"].values["trace"] - 1.0) <= 1e-3


def test_harness_main_prints_33_of_33(jax_rows, capsys):
    assert validation.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = parse_lines(out)
    assert [r[2] for r in rows] == [r[2] for r in jax_rows]
    assert all(r[1] for r in rows)
    assert [ln for ln in out.splitlines() if GROUP.match(ln)] == [
        f"Group {g}: {t}" for g, t in enumerate(
            ("Bell-state physics", "Norm preservation",
             "Measurement sanity", "Readout-error mode consistency", "QEC",
             "Reference invalidation & layer API", "Noise CPTP limits",
             "Performance regression", "Scaling proof"), start=1)]
    assert re.fullmatch(r"33/33 assertions passed in [\d.]+ s",
                        out.strip().splitlines()[-1])


def test_acceptance_plans_reach_the_kernels():
    """The group-plan steps the card runs: group 8 two dense steps, group
    9 three, the latency circuit and its edits 10 dense and 8 cross."""
    def steps(c):
        plan = tplan.build_group_plan(tprog.compile_circuit(c))
        return (sum(isinstance(s, tplan.AxisMatmulStep) for s in plan.steps),
                sum(isinstance(s, tplan.CrossStep) for s in plan.steps))

    assert steps(validation.ry_layers()) == (2, 0)
    assert steps(validation.h_layer()) == (3, 0)
    for edit in range(3):
        assert steps(interactive_latency_check.build(16, 8, 3, edit)) \
            == (10, 8)


# ---------------------------------------------------------------------------
# parity_check
# ---------------------------------------------------------------------------

def _jax_parity():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", REPO / "scripts" / "parity_check.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parity_twin_against_jax_run_ours():
    jp = _jax_parity()
    trials = 200
    jax_out = jp.run_ours(trials)
    ours = parity_check.run_ours(trials, "cpu")
    assert set(ours) == set(jax_out)
    checks = jp.compare(jax_out, ours, trials)
    assert len(checks) == 8
    assert all(c["passed"] for c in checks), checks
    # the twin's copy of compare is the script's
    assert parity_check.compare(jax_out, ours, trials) == checks


@pytest.mark.parametrize("given", [False, True],
                         ids=["no-reference-argument", "empty-directory"])
def test_parity_without_reference_exits_2(tmp_path, capsys, given):
    extra = ["--reference", str(tmp_path)] if given else []
    assert parity_check.main(["--device", "cpu", "--trials", "10"]
                             + extra) == 2
    root = str(tmp_path) if given else None
    assert f"Reference not available at {root} (pass --reference PATH); " \
        "aborting." in capsys.readouterr().out


def test_parity_reference_runs_in_the_named_checkout(monkeypatch, tmp_path):
    """The reference subprocess sees only the given checkout on its path
    and writes no bytecode into it."""
    (tmp_path / "quantum_sim").mkdir()
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(kw["env"])
        return subprocess.CompletedProcess(cmd, 0, stdout='{"x": 1}\n')

    monkeypatch.setattr(parity_check.subprocess, "run", fake_run)
    assert parity_check.run_reference(10, str(tmp_path)) == {"x": 1}
    assert seen["PYTHONPATH"] == str(tmp_path)
    assert seen["PYTHONDONTWRITEBYTECODE"] == "1"


# ---------------------------------------------------------------------------
# interactive_latency_check
# ---------------------------------------------------------------------------

def _jax_latency_keys() -> set[str]:
    """Every key the JAX script's ``out`` dict can hold (AST)."""
    tree = ast.parse((REPO / "scripts" /
                      "interactive_latency_check.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "out"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) and node.value.id == "out":
            keys.add(node.slice.value)
    return keys


DROPPED = {"fused_recompile_s", "second_process_note"}
ADDED = {"device", "power_limit", "second_process_library_prebuilt"}
ON_ERROR = {"second_process_error"}
SECOND = {"second_process_cold_s", "second_process_cold_under_10s",
          "second_process_library_prebuilt"}


@pytest.mark.parametrize("skip", [False, True])
def test_latency_twin_keys_and_files(monkeypatch, tmp_path, capsys, skip):
    record = REPO / "INTERACTIVE_r05.json"
    before = record.read_bytes()
    root_before = sorted(p.name for p in REPO.iterdir())
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "latency.json"
    argv = ["-n", "6", "--depth", "2", "--device", "cpu",
            "--output", str(out)] + (["--skip-subprocess"] if skip else [])
    assert interactive_latency_check.main(argv) == 0, \
        capsys.readouterr().err
    got = json.loads(out.read_text())
    want = (_jax_latency_keys() - DROPPED - ON_ERROR) | ADDED
    if skip:
        want -= SECOND
    assert set(got) == want
    assert got["platform"] == "cpu" and got["n"] == 6 and got["depth"] == 2
    assert got["edit_under_2s"] and got["noisy_edit_under_2s"]
    if not skip:
        assert got["second_process_cold_s"] > 0
        assert got["second_process_library_prebuilt"] is None   # no card
    assert record.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cwd",
                                                          "latency.json"]
    assert list(work.iterdir()) == []
    assert sorted(p.name for p in REPO.iterdir()) == root_before


# ---------------------------------------------------------------------------
# devices and imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", TWINS, ids=lambda m: m.__name__)
def test_no_card_and_no_device_exits_nonzero(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


@pytest.mark.parametrize("module", TWINS, ids=lambda m: m.__name__)
def test_no_jax_or_jax_package_imports(module):
    tree = ast.parse(Path(module.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "quantum_simulator_tpu",
                        "quantum_sim", "scripts", "test_validation"}, roots
