"""Runs of disjoint swaps (``ops.plan.swap_runs``) and the ``swap_bits``
kernel's index math (``ops.cuda_exec.swap_geometry``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: which plan steps form one run, that the bit pairs of a run, applied
as one index map, give what the step-by-step transposes of
``apply_bitpair`` give, and that the tile walk the kernel makes from its
geometry (emulated in NumPy) moves every element where the index map puts
it, each element written at most once."""

import itertools

import numpy as np
import pytest
import torch

import quantum_simulator_tpu_torch as tq
from quantum_simulator_tpu_torch.algorithms import AlgorithmTemplate
from quantum_simulator_tpu_torch.ops import cuda_exec
from quantum_simulator_tpu_torch.ops import plan as gplan
from quantum_simulator_tpu_torch.ops import program as prog
from quantum_simulator_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _plan(gates, n):
    c = tq.QuantumCircuit(n)
    for col, (name, targets) in enumerate(gates):
        c.add_gate(tq.GateInstance(name, list(targets), [], column=col))
    return gplan.build_group_plan(prog.compile_circuit(c))


def _swap_steps(plan):
    return [i for i, s in enumerate(plan.steps)
            if isinstance(s, gplan.BitPairStep)
            and plan.bitpair_specs[s.index].is_swap]


@pytest.mark.parametrize("n", range(8, 17))
def test_qft_swaps_are_one_run(n):
    """The QFT's closing swaps between two axes, odd and even n: one run
    covering every bit-pair step, their pairs disjoint."""
    plan = gplan.build_group_plan(prog.compile_circuit(
        AlgorithmTemplate.quantum_fourier_transform(n)))
    swaps = _swap_steps(plan)
    assert swaps and all(isinstance(s, gplan.BitPairStep) == (i in swaps)
                         for i, s in enumerate(plan.steps))
    assert gplan.swap_runs(plan) == [tuple(swaps)]
    bits = [b for i in swaps for b in gplan.step_bits(plan.layout,
                                                      plan.steps[i])]
    assert len(set(bits)) == len(bits) == 2 * len(swaps)


def test_a_shared_qubit_starts_a_new_run():
    """SWAP(a, b) then SWAP(b, c) is a 3-cycle, not one exchange: two
    runs."""
    plan = _plan([("SWAP", (0, 13)), ("SWAP", (13, 1)), ("SWAP", (2, 12))],
                 14)
    assert _swap_steps(plan) == [0, 1, 2]
    assert gplan.swap_runs(plan) == [(0,), (1, 2)]


def _layout_plan(kinds):
    """A plan on (128, 128) whose steps are ``kinds``: "swap" (a swap of
    the next free pair of bits), "pair" (a non-swap bit pair), "dense" or
    "diag"."""
    layout = gplan.GroupLayout.for_qubits(14)
    steps, specs = [], []
    free = itertools.count()
    for kind in kinds:
        if kind in ("swap", "pair"):
            k = next(free)
            specs.append(gplan.BitPairSpec(0, 0, kind == "swap"))
            steps.append(gplan.BitPairStep(0, k, 1, k, len(specs) - 1))
        elif kind == "dense":
            steps.append(gplan.AxisMatmulStep(0, 0))
        else:
            steps.append(gplan.DiagPairStep(0, 1, 0))
    return gplan.GroupPlan(layout, tuple(steps), (), (), (),
                           bitpair_specs=tuple(specs))


@pytest.mark.parametrize("between", ["pair", "dense", "diag"])
def test_a_step_between_swaps_ends_a_run(between):
    plan = _layout_plan(["swap", "swap", between, "swap"])
    assert gplan.swap_runs(plan) == [(0, 1), (3,)]


def test_runs_are_maximal():
    plan = _layout_plan(["dense", "swap", "swap", "swap", "diag", "swap"])
    assert gplan.swap_runs(plan) == [(1, 2, 3), (5,)]
    assert gplan.swap_runs(_layout_plan(["dense", "pair"])) == []


# ---------------------------------------------------------------------------
# The run's pairs as one index map against the steps one by one
# ---------------------------------------------------------------------------

def _qft_plan(n):
    return gplan.build_group_plan(prog.compile_circuit(
        AlgorithmTemplate.quantum_fourier_transform(n)))


@pytest.mark.parametrize("n", [9, 12, 15])
@pytest.mark.parametrize("planar,batched", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_run_pairs_as_index_map_equal_the_steps(n, planar, batched):
    """An ``arange`` state: the run's pairs applied at once by the plain
    twin (and the CPU wrapper) equal ``apply_bitpair`` step by step."""
    plan = _qft_plan(n)
    (run,) = gplan.swap_runs(plan)
    steps = [plan.steps[i] for i in run]
    lead = ((3,) if batched else ()) + ((2,) if planar else ())
    shape = lead + tuple(plan.layout.axis_sizes)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    want = x
    for s in steps:
        want = gplan.apply_bitpair(want, plan, s, None, planar, batched)
    pairs = [gplan.step_bits(plan.layout, s) for s in steps]
    got = cuda_exec.swap_bits_plain(x, pairs, planar, batched)
    assert torch.equal(got, want)
    assert torch.equal(cuda_exec.swap_bits(x, pairs, planar, batched), want)
    assert torch.equal(
        gplan.apply_bitpair_step(x, plan, steps[0], None, planar, batched,
                                 run=tuple(steps)), want)


def test_run_step_records_one_pass_and_checks_its_run():
    plan = _qft_plan(10)
    (run,) = gplan.swap_runs(plan)
    steps = tuple(plan.steps[i] for i in run)
    x = torch.randn((2,) + tuple(plan.layout.axis_sizes))
    with profiling.recording() as rec:
        gplan.apply_bitpair_step(x, plan, steps[0], None, True, run=steps)
    assert [(p.kind, p.chunks, p.swap) for p in rec.passes] == [
        ("bitpair", 1, True)]
    assert rec.spans[rec.passes[0].span].name == "step.bitpair"
    with pytest.raises(ValueError):
        gplan.apply_bitpair_step(x, plan, steps[1], None, True, run=steps)


def test_executor_on_the_cpu_runs_each_swap_step(monkeypatch):
    """On the CPU the executor keeps one chunked transpose pass a swap
    step: the run path is the card's."""
    plan = _qft_plan(10)
    calls = []
    orig = gplan.apply_bitpair_step

    def spy(*a, **k):
        calls.append(k.get("run"))
        return orig(*a, **k)

    p = prog.compile_circuit(AlgorithmTemplate.quantum_fourier_transform(10))
    ops = gplan.operands_to(
        gplan.build_group_operands(p, plan, p.initial_params), "cpu")
    x = gplan.basis_state(plan, 3, "cpu")
    monkeypatch.setattr(gplan, "apply_bitpair_step", spy)
    gplan.execute_group_plan(plan, ops, p, p.initial_params, x)
    assert calls == [None] * len(_swap_steps(plan))


def test_swap_pairs_refuse_shared_and_outside_bits():
    assert cuda_exec.swap_pairs([(5, 1), (2, 7)], 8) == ((1, 5), (2, 7))
    for bad in ([(1, 2), (2, 3)], [(1, 1)], [(0, 8)], [(-1, 3)]):
        with pytest.raises(ValueError):
            cuda_exec.swap_pairs(bad, 8)
    with pytest.raises(ValueError):
        cuda_exec.swap_bits_plain(torch.zeros(2, 16), [(0, 1), (1, 2)],
                                  True)


# ---------------------------------------------------------------------------
# The kernel's tile walk, emulated from its geometry
# ---------------------------------------------------------------------------

def _tile_walk(x, g, mode):
    """``csrc/swap_bits.cu`` over ``x`` (n_outer, 2^n), in NumPy: each
    unit decoded into its two tiles (or one), which it moves. Returns the
    result and how often each element was written."""
    out = x.copy()
    writes = np.zeros(x.shape, dtype=np.int64)
    cols = 1 << g.col_bits
    e = np.arange(cols << g.row_bits)
    off = e & (cols - 1)
    for j, pos in enumerate(g.row_pos):
        off |= ((e >> (g.col_bits + j)) & 1) << pos
    src = np.zeros_like(e)
    for i, p in enumerate(g.perm):
        src |= ((e >> p) & 1) << i
    K = len(g.pairs)
    s_bits = max(K - 1, 0)
    for unit in range(g.n_units):
        outer, uin = unit >> g.unit_shift, unit & ((1 << g.unit_shift) - 1)
        sp = uin & ((1 << s_bits) - 1)
        d = (uin >> s_bits) & ((1 << K) - 1)
        f = uin >> (s_bits + K)
        at = (d & -d).bit_length() - 1 if d else s_bits
        s = (sp & ((1 << at) - 1)) | ((sp >> at) << (at + 1))
        s2 = s ^ d if d else s | (1 << at)
        base = second = 0
        for k, (lo, hi) in enumerate(g.pairs):
            sk, dk, s2k = (s >> k) & 1, (d >> k) & 1, (s2 >> k) & 1
            base |= (sk << lo) | ((sk ^ dk) << hi)
            second |= (s2k << lo) | ((s2k ^ dk) << hi)
        for k, pos in enumerate(g.fixed):
            base |= ((f >> k) & 1) << pos
            second |= ((f >> k) & 1) << pos
        row = x[outer]
        if mode & cuda_exec.SWAP_EXCHANGE:
            assert (src == e).all()
            if d:
                out[outer, second + off] = row[base + off]
                out[outer, base + off] = row[second + off]
                writes[outer, second + off] += 1
                writes[outer, base + off] += 1
            continue
        moves = [(base, second if d else base)]
        if K:
            moves.append((second, base if d else second))
        for frm, to in moves:
            out[outer, to + off] = row[frm + off[src]]
            writes[outer, to + off] += 1
    return out, writes


def _random_pairs(rng, n, k):
    bits = rng.permutation(n)[:2 * k]
    return [(int(bits[2 * i]), int(bits[2 * i + 1])) for i in range(k)]


CASES = ([(n, itemsize, seed) for n in (1, 3, 6, 9, 12) for itemsize in (4, 8)
          for seed in range(4)]
         + [(10, 4, "qft"), (10, 8, "qft"), (12, 4, "high"),
            (12, 8, "high"), (11, 4, "bits5-6"), (13, 8, "inC")])


@pytest.mark.parametrize("n,itemsize,seed", CASES)
def test_tile_walk_equals_the_index_map(n, itemsize, seed):
    """Random runs of every size, the QFT's pairs, a run with no bit in
    the tile's columns ("high"), one touching bits 5-6 of the innermost
    axis, and one with a pair inside the columns: the walk writes every
    element that pi moves once, no fixed element more than once, and
    gives what the index map gives."""
    rng = np.random.default_rng([n, itemsize, CASES.index((n, itemsize,
                                                           seed))])
    if seed == "qft":
        pairs = [(q, n - 1 - q) for q in range(n // 2)]
    elif seed == "high":
        pairs = [(6, 11), (7, 9)]
    elif seed == "bits5-6":
        pairs = [(5, 8), (6, 10)]
    elif seed == "inC":
        pairs = [(0, 2), (1, 9), (5, 12)]
    else:
        pairs = _random_pairs(rng, n, int(rng.integers(1, n // 2 + 1))
                              if n > 1 else 0)
    n_outer = 3
    g = cuda_exec.swap_geometry(n, n_outer, pairs, itemsize)
    mode = cuda_exec.swap_mode(g, itemsize, 0)
    if seed == "high":
        assert mode == cuda_exec.SWAP_EXCHANGE | cuda_exec.SWAP_PACKS
    if seed == "qft" and n >= 10:
        assert mode == cuda_exec.SWAP_PACKS
    K = len(g.pairs)
    assert g.col_bits + g.row_bits + 2 * K + len(g.fixed) == n
    assert g.n_units == n_outer << (2 * K + len(g.fixed) - (K > 0))
    assert len(cuda_exec.swap_words(g)) == cuda_exec.SWAP_GEOM_WORDS
    x = rng.standard_normal((n_outer, 1 << n))
    got, writes = _tile_walk(x, g, mode)
    pi = cuda_exec.swap_index_map(n, pairs).numpy()
    assert np.array_equal(got, x[:, pi])
    moved = pi != np.arange(1 << n)
    assert (writes[:, moved] == 1).all() and writes.max() <= 1


def test_qft_30_geometry():
    """The QFT-30 run in float32: 64 x 64 tiles, column bits 0-5 against
    row bits 24-29, bits 6-13 against 16-23 on the tiles' bases, 14 and 15
    fixed: 2^17 units of two tiles a plane."""
    pairs = [(q, 29 - q) for q in range(14)]
    g = cuda_exec.swap_geometry(30, 2, pairs, 4)
    assert (g.col_bits, g.row_bits, g.row_pos) == (6, 6, tuple(range(24,
                                                                     30)))
    assert g.pairs == tuple((b, 29 - b) for b in range(6, 14))
    assert g.fixed == (14, 15) and g.n_units == 2 << 17
    assert g.perm == tuple(range(11, -1, -1))


def _source():
    from pathlib import Path

    return (Path(cuda_exec.__file__).resolve().parent.parent / "csrc"
            / "swap_bits.cu").read_text()


def test_kernel_source_agrees_with_the_wrapper():
    """The limits and the geometry's word count the kernel reads are the
    wrapper's; its one kernel is no fiber kernel (``qsbench.devtrace``
    matches fiber kernels to launch records by name), and its wrapper
    writes no launch record."""
    import inspect
    import re

    from qsbench.devtrace import FIBER_KERNEL

    src = _source()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kSwap\w+) = (\d+);", src)}
    assert (consts["kSwapMaxRowBits"], consts["kSwapMaxPairs"],
            consts["kSwapMaxFixed"], consts["kSwapMaxTileBits"]) == (
        cuda_exec.SWAP_MAX_ROW_BITS, cuda_exec.SWAP_MAX_PAIRS,
        cuda_exec.SWAP_MAX_FIXED, cuda_exec.SWAP_MAX_TILE_BITS)
    assert (consts["kSwapExchange"], consts["kSwapPacks"]) == (
        cuda_exec.SWAP_EXCHANGE, cuda_exec.SWAP_PACKS)
    words = re.search(r"kSwapGeomWords =\s*([^;]+);", src).group(1)
    total = eval(" ".join(words.split()), {}, consts)
    assert total == cuda_exec.SWAP_GEOM_WORDS
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert names == ["swap_bits_kernel"]
    assert not FIBER_KERNEL.search(names[0])
    body = inspect.getsource(cuda_exec.swap_bits)
    assert "_launch(" not in body and "profiling" not in body


def test_build_binds_swap_bits_with_its_own_argtypes(monkeypatch):
    import ctypes
    from types import SimpleNamespace

    from quantum_simulator_tpu_torch.ops import _build

    class FakeLib:
        def __getattr__(self, name):
            fn = SimpleNamespace(argtypes=None, restype=None)
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", lambda: "libqs_kernels.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    lib = _build._load.__wrapped__()
    assert lib.qs_swap_bits.argtypes == [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    assert lib.qs_swap_bits.restype is ctypes.c_int


def test_swap_bits_rejects_what_the_kernel_does_not_take_before_launch():
    x = torch.empty((2, 16, 128), device="meta")
    with pytest.raises(ValueError, match="expected CUDA or CPU"):
        cuda_exec.swap_bits(x, [(0, 10)], True)
    with pytest.raises(ValueError, match="at most 32"):
        cuda_exec.swap_geometry(33, 1, [(0, 32)], 4)
