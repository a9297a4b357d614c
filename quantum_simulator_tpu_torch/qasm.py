"""OpenQASM 2.0 interop: import/export for :class:`QuantumCircuit`.

Counterpart of ``quantum_simulator_tpu/interop.py`` (the port's own
``interop.py`` is the NumPy-to-torch operand helper and keeps that name):
a complete qelib1-level importer (custom ``gate`` macro expansion,
parameter expressions with ``pi`` and the qasm2 function set, register
broadcast, ``measure`` / ``barrier``) and an exporter that emits portable
qelib1 QASM from any circuit built here.

Import never touches a device: it produces the same host-side circuit
IR every engine consumes, with ASAP column packing (each gate lands in
the earliest column after the last use of any of its qubits, the same
column-as-time-step layout the editor produces).

Deliberate scope: OpenQASM 2.0 (the interchange format that exists in
the wild), not 3.0, whose classical control flow has no counterpart in
the circuit model. ``if`` statements and ``opaque`` declarations raise
with a clear message rather than silently dropping.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from .circuit import GateInstance, QuantumCircuit

__all__ = ["to_qasm", "from_qasm", "QasmError"]


class QasmError(ValueError):
    """Raised for unparseable or unsupported QASM input/output."""


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

# Fixed gates: engine name -> qelib1 name.
_EXPORT_FIXED = {
    "I": "id", "H": "h", "X": "x", "Y": "y", "Z": "z",
    "S": "s", "S_DAG": "sdg", "T": "t", "T_DAG": "tdg",
    "CNOT": "cx", "CZ": "cz", "SWAP": "swap",
    "Toffoli": "ccx", "Fredkin": "cswap",
}
# Parameterized gates: engine name -> qelib1 name (arg order preserved).
_EXPORT_PARAM = {
    "Rx": "rx", "Ry": "ry", "Rz": "rz",
    "Phase": "u1", "U3": "u3", "CPhase": "cu1",
}


def _fmt(x: float) -> str:
    """Render a parameter compactly, using pi multiples when exact-ish."""
    for denom in (1, 2, 3, 4, 6, 8, 16):
        for num in range(-16 * denom, 16 * denom + 1):
            if num == 0:
                continue
            if abs(x - num * math.pi / denom) < 1e-12:
                sign = "-" if num < 0 else ""
                num = abs(num)
                head = "pi" if num == 1 else f"{num}*pi"
                return f"{sign}{head}" if denom == 1 else \
                    f"{sign}{head}/{denom}"
    if x == 0:
        return "0"
    return repr(float(x))


def to_qasm(circuit: QuantumCircuit) -> str:
    """Serialize to OpenQASM 2.0 text (qelib1 gate set).

    Qubits with ``initial_states[q] == 1`` are prepared by a leading
    ``x`` column (QASM has no state-prep statement). ``Measure`` gates
    become ``measure q[i] -> c[i]``; ``Barrier`` instances in the same
    column merge into one ``barrier`` statement. Gates with no qelib1
    counterpart (``MCZ4``+, runtime custom gates) raise
    :class:`QasmError` naming the offender.
    """
    n = circuit.num_qubits
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n}];",
        f"creg c[{n}];",
    ]
    for q, s in enumerate(circuit.initial_states):
        if s:
            lines.append(f"x q[{q}];  // initial state |1>")
    for column in circuit.get_ordered_gates():
        barrier_qubits: list[int] = []
        for g in column:
            name = g.gate_name
            args = ",".join(f"q[{t}]" for t in g.target_qubits)
            if name in _EXPORT_FIXED:
                lines.append(f"{_EXPORT_FIXED[name]} {args};")
            elif name in _EXPORT_PARAM:
                ps = ",".join(_fmt(p) for p in g.params)
                lines.append(f"{_EXPORT_PARAM[name]}({ps}) {args};")
            elif name == "Measure":
                lines.extend(f"measure q[{t}] -> c[{t}];"
                             for t in g.target_qubits)
            elif name == "Barrier":
                barrier_qubits.extend(g.target_qubits)
            elif re.fullmatch(r"MCZ(\d+)", name):
                k = int(name[3:])
                if k == 2:
                    lines.append(f"cz {args};")
                elif k == 3:
                    # ccz = H on last target conjugating ccx (qelib1 has
                    # no ccz primitive).
                    a, b, c = g.target_qubits
                    lines.append(f"h q[{c}];")
                    lines.append(f"ccx q[{a}],q[{b}],q[{c}];")
                    lines.append(f"h q[{c}];")
                else:
                    raise QasmError(
                        f"{name} has no qelib1 decomposition here; "
                        "synthesize it before export")
            else:
                raise QasmError(
                    f"gate '{name}' has no OpenQASM 2.0 mapping")
        if barrier_qubits:
            args = ",".join(f"q[{t}]" for t in sorted(barrier_qubits))
            lines.append(f"barrier {args};")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Import: parameter expressions
# ---------------------------------------------------------------------------

_EXPR_OK = re.compile(r"^[\w+\-*/(). ^]*$")
_EXPR_ENV = {
    "pi": math.pi, "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "exp": math.exp, "ln": math.log, "sqrt": math.sqrt,
}
# Numbers first so '1e-05' tokenizes as one literal, never as ident 'e'.
_EXPR_TOKEN = re.compile(
    r"\s*(?:(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<op>[-+*/^()]))")


def _eval_expr(text: str, env: dict[str, float]) -> float:
    """Evaluate a qasm2 parameter expression (numbers incl. scientific
    notation, pi, + - * / ^, parentheses, the qasm2 function set, and
    bound gate parameters).

    Recursive-descent over a token stream — no ``eval``, and all
    arithmetic is float (so hostile integer power towers like
    ``9^9^9^9`` overflow to an error instead of building bignums).
    """
    text = text.strip()
    if not _EXPR_OK.match(text):
        raise QasmError(f"unsupported characters in expression: {text!r}")
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _EXPR_TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            if text[pos:].strip():
                raise QasmError(f"bad expression {text!r} at offset {pos}")
            break
        pos = m.end()
        kind = m.lastgroup
        tokens.append((kind, m.group(kind)))
    tokens.append(("end", ""))
    names = {v for k, v in tokens if k == "name"}
    allowed = set(_EXPR_ENV) | set(env)
    unknown = names - allowed
    if unknown:
        raise QasmError(f"unknown identifier(s) {sorted(unknown)} "
                        f"in expression {text!r}")
    scope = {**_EXPR_ENV, **env}
    idx = 0

    def peek():
        return tokens[idx]

    def take():
        nonlocal idx
        tok = tokens[idx]
        idx += 1
        return tok

    def expr() -> float:          # term (('+'|'-') term)*
        val = term()
        while peek() == ("op", "+") or peek() == ("op", "-"):
            _, op = take()
            rhs = term()
            val = val + rhs if op == "+" else val - rhs
        return val

    def term() -> float:          # unary (('*'|'/') unary)*
        val = unary()
        while peek() == ("op", "*") or peek() == ("op", "/"):
            _, op = take()
            rhs = unary()
            val = val * rhs if op == "*" else val / rhs
        return val

    def unary() -> float:         # ('+'|'-')* power
        sign = 1.0
        while peek() == ("op", "+") or peek() == ("op", "-"):
            if take()[1] == "-":
                sign = -sign
        return sign * power()

    def power() -> float:         # atom ('^' unary)?  — right-assoc
        base = atom()
        if peek() == ("op", "^"):
            take()
            return base ** unary()
        return base

    def atom() -> float:
        kind, val = take()
        if kind == "num":
            return float(val)
        if kind == "name":
            obj = scope[val]
            if callable(obj):
                if take() != ("op", "("):
                    raise QasmError(f"function {val!r} needs parentheses "
                                    f"in {text!r}")
                arg = expr()
                if take() != ("op", ")"):
                    raise QasmError(f"unbalanced parentheses in {text!r}")
                return float(obj(arg))
            return float(obj)
        if (kind, val) == ("op", "("):
            inner = expr()
            if take() != ("op", ")"):
                raise QasmError(f"unbalanced parentheses in {text!r}")
            return inner
        raise QasmError(f"unexpected token {val!r} in expression {text!r}")

    try:
        result = expr()
        if peek() != ("end", ""):
            raise QasmError(
                f"trailing tokens in expression {text!r}")
        return float(result)
    except QasmError:
        raise
    except Exception as exc:  # overflow, div-by-zero, math-domain
        raise QasmError(f"bad expression {text!r}: {exc}") from exc


# ---------------------------------------------------------------------------
# Import: parser
# ---------------------------------------------------------------------------

@dataclass
class _GateDef:
    params: list[str]
    qubits: list[str]
    body: list[str]          # raw statements


_GATE_DEF_RE = re.compile(
    r"gate\s+(?P<name>[A-Za-z_]\w*)\s*"
    r"(?:\(\s*(?P<params>[^)]*)\)\s*)?"
    r"(?P<qubits>[A-Za-z_][\w\s,]*?)\s*"
    r"\{(?P<body>[^}]*)\}", re.S)

_APP_RE = re.compile(
    r"^(?P<name>[A-Za-z_]\w*)\s*"
    r"(?:\(\s*(?P<params>.*)\)\s*)?"
    r"(?P<args>[A-Za-z_].*)?$", re.S)

# Builtin + qelib1 single-name imports: qasm name -> (engine name, n_params).
_IMPORT_DIRECT = {
    "id": ("I", 0), "h": ("H", 0), "x": ("X", 0), "y": ("Y", 0),
    "z": ("Z", 0), "s": ("S", 0), "sdg": ("S_DAG", 0), "t": ("T", 0),
    "tdg": ("T_DAG", 0), "rx": ("Rx", 1), "ry": ("Ry", 1),
    "rz": ("Rz", 1), "u1": ("Phase", 1), "p": ("Phase", 1),
    "u3": ("U3", 3), "u": ("U3", 3), "U": ("U3", 3),
    "cx": ("CNOT", 0), "CX": ("CNOT", 0), "cz": ("CZ", 0),
    "swap": ("SWAP", 0), "ccx": ("Toffoli", 0), "cswap": ("Fredkin", 0),
    "cu1": ("CPhase", 1), "cp": ("CPhase", 1),
}


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


class _Importer:
    def __init__(self) -> None:
        self.regs: dict[str, tuple[int, int]] = {}   # name -> (offset, size)
        self.cregs: dict[str, int] = {}
        self.defs: dict[str, _GateDef] = {}
        self.ops: list[tuple[str, list[float], list[int]]] = []
        self.n_qubits = 0

    # --- operand resolution -------------------------------------------

    def _resolve(self, arg: str) -> list[int] | tuple[int, int]:
        """``q[3]`` -> [abs_index]; bare ``q`` -> (offset, size) for
        broadcast."""
        arg = arg.strip()
        m = re.fullmatch(r"([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]", arg)
        if m:
            name, idx = m.group(1), int(m.group(2))
            if name not in self.regs:
                raise QasmError(f"unknown quantum register {name!r}")
            off, size = self.regs[name]
            if idx >= size:
                raise QasmError(f"{name}[{idx}] out of range (size {size})")
            return [off + idx]
        if re.fullmatch(r"[A-Za-z_]\w*", arg):
            if arg not in self.regs:
                raise QasmError(f"unknown quantum register {arg!r}")
            return self.regs[arg]
        raise QasmError(f"bad operand {arg!r}")

    def _broadcast(self, operands: list[str]) -> list[list[int]]:
        """qasm2 register broadcast: full registers iterate in lockstep,
        single qubits repeat."""
        resolved = [self._resolve(a) for a in operands]
        widths = {r[1] for r in resolved if isinstance(r, tuple)}
        if len(widths) > 1:
            raise QasmError(
                f"mismatched register widths in broadcast: {sorted(widths)}")
        width = widths.pop() if widths else 1
        rows = []
        for i in range(width):
            row = []
            for r in resolved:
                row.append(r[0] + i if isinstance(r, tuple) else r[0])
            if len(set(row)) != len(row):
                raise QasmError(f"duplicate qubit in operands {operands}")
            rows.append(row)
        return rows

    # --- statement handling ---------------------------------------------

    def _emit(self, name: str, params: list[float],
              qubits: list[int]) -> None:
        self.ops.append((name, params, qubits))

    def _apply(self, name: str, params: list[float],
               qubits: list[int]) -> None:
        if name in _IMPORT_DIRECT:
            engine, n_p = _IMPORT_DIRECT[name]
            if len(params) != n_p:
                raise QasmError(
                    f"{name} expects {n_p} parameter(s), got {len(params)}")
            self._emit(engine, params, qubits)
        elif name == "u2":
            if len(params) != 2:
                raise QasmError("u2 expects 2 parameters")
            self._emit("U3", [math.pi / 2, params[0], params[1]], qubits)
        elif name in self.defs:
            self._expand(self.defs[name], params, qubits)
        else:
            raise QasmError(f"unknown gate {name!r}")

    def _expand(self, gdef: _GateDef, params: list[float],
                qubits: list[int]) -> None:
        if len(params) != len(gdef.params):
            raise QasmError(
                f"gate expects {len(gdef.params)} parameter(s), "
                f"got {len(params)}")
        if len(qubits) != len(gdef.qubits):
            raise QasmError(
                f"gate expects {len(gdef.qubits)} qubit(s), "
                f"got {len(qubits)}")
        penv = dict(zip(gdef.params, params))
        qenv = dict(zip(gdef.qubits, qubits))
        for stmt in gdef.body:
            m = _APP_RE.match(stmt)
            if not m:
                raise QasmError(f"bad statement in gate body: {stmt!r}")
            name = m.group("name")
            if name == "barrier":
                continue  # barriers inside macros are scheduling hints only
            sub_params = [_eval_expr(p, penv)
                          for p in _split_top(m.group("params") or "")]
            sub_qubits = []
            for a in _split_top(m.group("args") or ""):
                a = a.strip()
                if a not in qenv:
                    raise QasmError(f"unknown qubit {a!r} in gate body")
                sub_qubits.append(qenv[a])
            self._apply(name, sub_params, sub_qubits)

    def feed(self, stmt: str) -> None:
        stmt = stmt.strip()
        if not stmt or stmt.startswith("OPENQASM") or \
                stmt.startswith("include"):
            return
        if stmt.startswith("if") or stmt.startswith("opaque") or \
                stmt.startswith("reset"):
            raise QasmError(
                f"unsupported OpenQASM statement: {stmt.split()[0]!r}")
        m = re.fullmatch(r"qreg\s+([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]", stmt)
        if m:
            name, size = m.group(1), int(m.group(2))
            if name in self.regs:
                raise QasmError(f"duplicate register {name!r}")
            self.regs[name] = (self.n_qubits, size)
            self.n_qubits += size
            return
        m = re.fullmatch(r"creg\s+([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]", stmt)
        if m:
            self.cregs[m.group(1)] = int(m.group(2))
            return
        m = re.fullmatch(r"measure\s+(.+?)\s*->\s*(.+)", stmt)
        if m:
            for row in self._broadcast([m.group(1)]):
                self._emit("Measure", [], row)
            return
        if stmt.startswith("barrier"):
            operands = _split_top(stmt[len("barrier"):])
            qubits: list[int] = []
            for r in (self._resolve(a) for a in operands):
                qubits.extend(range(r[0], r[0] + r[1])
                              if isinstance(r, tuple) else r)
            self._emit("Barrier", [], sorted(set(qubits)))
            return
        m = _APP_RE.match(stmt)
        if not m or not m.group("args"):
            raise QasmError(f"unparseable statement: {stmt!r}")
        params = [_eval_expr(p, {})
                  for p in _split_top(m.group("params") or "")]
        for row in self._broadcast(_split_top(m.group("args"))):
            self._apply(m.group("name"), params, row)

    # --- output ----------------------------------------------------------

    def build(self) -> QuantumCircuit:
        if self.n_qubits == 0:
            raise QasmError("no qreg declared")
        circuit = QuantumCircuit(num_qubits=self.n_qubits)
        next_free = [0] * self.n_qubits
        for name, params, qubits in self.ops:
            if name == "Barrier":
                # sync point across its qubits; one Barrier instance per
                # qubit (editor convention: Barrier is a 1-qubit marker)
                col = max(next_free[q] for q in qubits)
                for q in qubits:
                    circuit.add_gate(GateInstance("Barrier", [q], [], col))
                    next_free[q] = col + 1
                continue
            col = max(next_free[q] for q in qubits)
            circuit.add_gate(GateInstance(name, qubits, params, col))
            for q in qubits:
                next_free[q] = col + 1
        return circuit


def _split_top(text: str) -> list[str]:
    """Split on commas not inside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    return [p.strip() for p in parts if p.strip()]


def from_qasm(text: str) -> QuantumCircuit:
    """Parse OpenQASM 2.0 text into a :class:`QuantumCircuit`.

    Supports the full qelib1 single-name set (plus builtin ``U``/``CX``
    and the qasm3-spelling aliases ``p``/``cp``/``u``), user ``gate``
    macro definitions (recursively expanded with parameter-expression
    substitution), register broadcast (``h q;``), ``measure`` and
    ``barrier``. Multiple ``qreg`` declarations flatten in declaration
    order. Gates pack ASAP into columns.
    """
    text = _strip_comments(text)
    imp = _Importer()

    def _collect_def(m: re.Match) -> str:
        name = m.group("name")
        params = _split_top(m.group("params") or "")
        qubits = _split_top(m.group("qubits") or "")
        body = [s.strip() for s in m.group("body").split(";") if s.strip()]
        imp.defs[name] = _GateDef(params, qubits, body)
        return " "

    text = _GATE_DEF_RE.sub(_collect_def, text)
    for stmt in text.split(";"):
        imp.feed(stmt)
    return imp.build()
