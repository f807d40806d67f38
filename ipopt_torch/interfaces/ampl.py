"""AMPL .nl reader and .sol writer (port of ``ipopt_tpu/interfaces/ampl.py``;
the reference Ipopt's AmplSolver: ``AmplTNLP``, ``AmplSuffixHandler``,
``ampl_ipopt.cpp``).

The .nl expression graph is parsed as the reference parses it, then
compiled once, at read time, into a tape: the DAG's nodes are sorted into
topological levels, and each (level, opcode, arity) group is evaluated by
one tensor op over the gathered operand values.  AMPL models come from
indexed constraints, so a model of 1e5 rows has tens of groups, not 1e5
nodes, and one evaluation costs tens of tensor ops.  Gathers and
elementwise ops compose with ``torch.func`` and ``vmap``, so the solver's
exact first and second derivatives come as for any ``NLP``.  Defined
variables (V segments) are nodes of the DAG, evaluated once per evaluation
wherever they are referenced (the reference's per-evaluation cache).  The
Jacobian pattern (the J segments and the variables each constraint's tree
reaches) and the Lagrangian Hessian pattern (all pairs of the variables of
each constraint and of each term of the objective's top-level sum) are
declared on the NLP, so ``linear_solver="banded-bcr"`` and
``"multifrontal"`` take .nl models of any size.

Formats (D. Gay, "Writing .nl Files", and the grammar of ASL's fg_read.c):
ASCII ('g' header) and binary ('b' header: tag letters as single bytes,
4-byte native ints and 8-byte IEEE doubles).  Supported: continuous smooth
models (C/O expressions over the common ASL opcodes, J/G linear parts, r/b
bounds, x and d initial guesses, V defined variables, S suffixes with the
warm-start duals ``ipopt_zL_in``/``ipopt_zU_in`` and ``scaling_factor``).
Rejected, as the reference rejects them: integer variables,
complementarity, SOS declarations, imported functions (F), logical
constraints (L).

CLI (the ``ipopt`` executable):
    python -m ipopt_torch.interfaces.ampl model.nl [-AMPL] [option=value ...]
writes model.sol with ipopt_zL_out/ipopt_zU_out suffixes.  It solves on the
CUDA device unless ``device=cpu`` is given.
"""
from __future__ import annotations

import struct
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..problem import NLP
from ..options import Options

# ASL opcodes (asl/opcode.hd)
_BINOPS = {
    0: torch.add,
    1: torch.sub,
    2: torch.mul,
    3: torch.div,
    4: torch.remainder,
    5: torch.pow,
    48: torch.atan2,
}
_UNOPS = {
    13: torch.floor,
    14: torch.ceil,
    15: torch.abs,
    16: torch.neg,
    37: torch.tanh,
    38: torch.tan,
    39: torch.sqrt,
    40: torch.sinh,
    41: torch.sin,
    42: torch.log10,
    43: torch.log,
    44: torch.exp,
    45: torch.cosh,
    46: torch.cos,
    47: torch.atanh,
    49: torch.atan,
    50: torch.asinh,
    51: torch.asin,
    52: torch.acosh,
    53: torch.acos,
}
_OP_SUMLIST = 54
_OP_MINLIST = 11
_OP_MAXLIST = 12
_NARY = (_OP_SUMLIST, _OP_MINLIST, _OP_MAXLIST)


class _AsciiReader:
    """Token reader over the line-oriented ASCII format."""

    def __init__(self, data: bytes, pos: int):
        text = data[pos:].decode("ascii", errors="replace")
        self.lines: List[str] = []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if line:
                self.lines.append(line)
        self.pos = 0

    def at_end(self) -> bool:
        return self.pos >= len(self.lines)

    def seg_header(self) -> Tuple[str, List[str]]:
        """Next segment: (tag char, remaining header tokens)."""
        line = self.lines[self.pos]
        self.pos += 1
        return line[0], line[1:].split()

    def expr_node(self):
        """('o', opcode) | ('n', value) | ('v', index)."""
        line = self.lines[self.pos]
        self.pos += 1
        kind = line[0]
        rest = line[1:].strip()
        if kind == "n":
            return "n", float(rest)
        if kind == "v":
            return "v", int(rest)
        if kind == "o":
            return "o", int(rest)
        raise ValueError(f"unexpected .nl expression line: {line!r}")

    def int_line(self) -> int:
        v = int(self.lines[self.pos].split()[0])
        self.pos += 1
        return v

    def int_pair(self) -> Tuple[int, float]:
        t = self.lines[self.pos].split()
        self.pos += 1
        return int(t[0]), float(t[1])

    def suf_entry(self, real: bool) -> Tuple[int, float]:
        return self.int_pair()

    def bound(self) -> Tuple[float, float]:
        return _decode_bound(self.lines[self.pos].split(), self)


class _BinaryReader:
    """Token reader over the binary format: tag letters as single bytes,
    native 4-byte ints and 8-byte doubles, no newlines."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos

    def at_end(self) -> bool:
        return self.pos >= len(self.data)

    def _int(self) -> int:
        v = struct.unpack_from("<i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def _dbl(self) -> float:
        v = struct.unpack_from("<d", self.data, self.pos)[0]
        self.pos += 8
        return v

    def _tag(self) -> str:
        c = chr(self.data[self.pos])
        self.pos += 1
        return c

    def seg_header(self) -> Tuple[str, List[str]]:
        tag = self._tag()
        # header field counts per segment tag (grammar of fg_read.c)
        counts = {"C": 1, "O": 2, "x": 1, "d": 1, "r": 0, "b": 0, "k": 1,
                  "J": 2, "G": 2, "V": 3, "S": 2, "F": 4, "L": 1}
        if tag not in counts:
            raise ValueError(f"unknown binary .nl segment {tag!r}")
        vals = [str(self._int()) for _ in range(counts[tag])]
        if tag == "S":
            # S kind n name: the name is a newline-terminated ASCII string
            end = self.data.index(b"\n", self.pos)
            vals.append(self.data[self.pos:end].decode("ascii").strip())
            self.pos = end + 1
        return tag, vals

    def expr_node(self):
        kind = self._tag()
        if kind == "n":
            return "n", self._dbl()
        if kind == "v":
            return "v", self._int()
        if kind == "o":
            return "o", self._int()
        raise ValueError(f"unexpected binary .nl expression tag {kind!r}")

    def int_line(self) -> int:
        return self._int()

    def int_pair(self) -> Tuple[int, float]:
        return self._int(), self._dbl()

    def suf_entry(self, real: bool) -> Tuple[int, float]:
        j = self._int()
        return j, (self._dbl() if real else float(self._int()))

    def bound(self) -> Tuple[float, float]:
        code = self._int()
        if code == 0:
            return self._dbl(), self._dbl()
        if code == 1:
            return -np.inf, self._dbl()
        if code == 2:
            return self._dbl(), np.inf
        if code == 3:
            return -np.inf, np.inf
        if code == 4:
            v = self._dbl()
            return v, v
        raise NotImplementedError(f"bound code {code} (complementarity?) "
                                  "not supported")


def _decode_bound(tokens, rdr) -> Tuple[float, float]:
    """Decode one r/b-section line; consumes the line from ``rdr``."""
    code = int(tokens[0])
    if code == 0:
        out = float(tokens[1]), float(tokens[2])
    elif code == 1:
        out = -np.inf, float(tokens[1])
    elif code == 2:
        out = float(tokens[1]), np.inf
    elif code == 3:
        out = -np.inf, np.inf
    elif code == 4:
        v = float(tokens[1])
        out = v, v
    else:
        raise NotImplementedError(f"bound code {code} (complementarity?) "
                                  "not supported")
    rdr.pos += 1
    return out


class _Tape:
    """A compiled expression DAG.  Values live in one vector V: the variables
    (n_var), then the constants, then the nodes level by level; each group
    of a level is one tensor op over operands gathered from V."""

    def __init__(self, n_var, consts, levels, outputs):
        self.n_var = n_var
        self.consts = np.asarray(consts, np.float64)
        # levels: [[(kind, op, arity, cmask, idx (cnt, arity) int64)]]; the
        # operands marked in cmask index the constants, the others V
        self.levels = levels
        self.outputs = np.asarray(outputs, np.int64)
        self._cache: Dict[Any, Any] = {}

    def _on(self, x):
        key = (x.dtype, x.device)
        t = self._cache.get(key)
        if t is None:
            t = (torch.as_tensor(self.consts, dtype=x.dtype, device=x.device),
                 [[(k, op, a, cm, torch.as_tensor(idx, device=x.device))
                   for k, op, a, cm, idx in lvl] for lvl in self.levels],
                 torch.as_tensor(self.outputs, device=x.device))
            self._cache[key] = t
        return t

    @property
    def n_groups(self):
        return sum(len(lvl) for lvl in self.levels)

    def __call__(self, x):
        """The outputs' values at x (n_var,)."""
        consts, levels, outputs = self._on(x)
        V = torch.cat([x, consts])
        for lvl in levels:
            vals = [_apply(*grp, V, consts) for grp in lvl]
            V = torch.cat([V] + vals)
        return V[outputs]


def _apply(kind, op, arity, cmask, idx, V, consts):
    """One group's values; an operand marked in ``cmask`` is a constant,
    gathered from ``consts`` (no tangent: a constant exponent of ``pow`` must
    not bring log(base) into the derivatives)."""
    def arg(j):
        return consts[idx[:, j]] if cmask[j] else V[idx[:, j]]
    if kind == "bin":
        return _BINOPS[op](arg(0), arg(1))
    if kind == "un":
        return _UNOPS[op](arg(0))
    if op == _OP_SUMLIST and arity > 8:
        return V[idx].sum(-1)
    # the reference's left fold: sum, min or max of the arguments in order
    fold = {_OP_SUMLIST: torch.add, _OP_MINLIST: torch.minimum,
            _OP_MAXLIST: torch.maximum}[op]
    out = V[idx[:, 0]]
    for j in range(1, arity):
        out = fold(out, V[idx[:, j]])
    return out


_BIN, _UN, _NA = "bin", "un", "nary"
# a reference to a value: a variable is its index i >= 0, a constant k is
# -1 - k, a node j is _NODE + j
_NODE = 1 << 40


class _Compiler:
    """Expressions -> DAG nodes, read straight from the .nl tokens, -> tapes.
    Variables, constants (by value) and defined variables are shared; every
    other expression node is a node.  Children are created before their
    parents, so node ids are a topological order."""

    def __init__(self, n_var):
        self.n_var = n_var
        self.const_ids: Dict[float, int] = {}
        self.consts: List[float] = []
        self.kind: List[str] = []
        self.op: List[int] = []
        self.level: List[int] = []
        self.start: List[int] = []
        self.arity: List[int] = []
        self.child: List[int] = []          # children of every node, flat
        self.defs: Dict[int, int] = {}      # defined variable -> reference
        self._arrays = None

    def const(self, v) -> int:
        key = float(v)
        k = self.const_ids.get(key)
        if k is None:
            k = self.const_ids[key] = len(self.consts)
            self.consts.append(key)
        return -1 - k

    def var(self, i) -> int:
        if i < self.n_var:
            return i
        if i not in self.defs:
            raise ValueError(f".nl variable v{i} is neither a variable nor a "
                             "defined variable read before it")
        return self.defs[i]

    def node(self, kind, op, children) -> int:
        level = self.level
        self.level.append(1 + max(level[c - _NODE] if c >= _NODE else 0
                                  for c in children))
        self.kind.append(kind)
        self.op.append(op)
        self.start.append(len(self.child))
        self.arity.append(len(children))
        self.child.extend(children)
        return _NODE + len(self.kind) - 1

    def define(self, i, lin, ref):
        """Defined variable i := ref + c_1 v_1 + c_2 v_2 ... (the reference's
        per-evaluation cache entry, ``_eval_expr``)."""
        if lin:
            terms = [ref] + [self.node(_BIN, 2, [self.const(c), self.var(j)])
                             for j, c in lin]
            ref = self.node(_NA, _OP_SUMLIST, terms)
        self.defs[i] = ref

    def parse(self, rdr) -> int:
        """The reference of the expression at the reader's position."""
        frames: List[list] = []             # [kind, op, children, wanted]
        while True:
            t, val = rdr.expr_node()
            if t == "n":
                ref = self.const(val)
            elif t == "v":
                ref = self.var(val)
            elif val in _BINOPS:
                frames.append([_BIN, val, [], 2])
                continue
            elif val in _UNOPS:
                frames.append([_UN, val, [], 1])
                continue
            elif val in _NARY:
                cnt = rdr.int_line()
                if cnt < 1:
                    raise ValueError(f".nl o{val} with {cnt} arguments")
                frames.append([_NA, val, [], cnt])
                continue
            else:
                raise NotImplementedError(f".nl opcode o{val} not supported")
            while frames:
                fr = frames[-1]
                fr[2].append(ref)
                if len(fr[2]) < fr[3]:
                    break
                frames.pop()
                ref = self.node(fr[0], fr[1], fr[2])
            else:
                return ref

    # -- after parsing: numpy views of the node lists -----------------------
    def arrays(self):
        if self._arrays is None:
            self._arrays = dict(
                kind=np.array([{_BIN: 0, _UN: 1, _NA: 2}[k] for k in self.kind], np.int8),
                op=np.array(self.op, np.int64), level=np.array(self.level, np.int64),
                start=np.array(self.start, np.int64), arity=np.array(self.arity, np.int64),
                child=np.array(self.child, np.int64))
        return self._arrays

    def children(self, nodes):
        """(parent position in ``nodes``, child reference) of every child."""
        A = self.arrays()
        st, ar = A["start"][nodes], A["arity"][nodes]
        rep = np.repeat(np.arange(len(nodes)), ar)
        first = np.repeat(np.cumsum(ar) - ar, ar)
        return rep, A["child"][np.repeat(st, ar) + np.arange(int(ar.sum())) - first]

    def tape(self, roots) -> _Tape:
        """The tape of the nodes ``roots`` reach, with the roots as outputs."""
        A = self.arrays()
        N = len(self.kind)
        roots = np.asarray(roots, np.int64)
        live = np.zeros(N, bool)
        live[roots[roots >= _NODE] - _NODE] = True
        for lvl in range(int(A["level"].max(initial=0)), 1, -1):
            _, ch = self.children(np.nonzero(live & (A["level"] == lvl))[0])
            live[ch[ch >= _NODE] - _NODE] = True
        ids = np.nonzero(live)[0]
        kind, op, arity = A["kind"][ids], A["op"][ids], A["arity"][ids]
        st = A["start"][ids]
        is_c = A["child"] < 0
        # which operands of a binary or unary node are constants
        cm0 = np.where(kind < 2, is_c[st], False)
        cm1 = np.where(kind == 0, is_c[np.minimum(st + 1, len(is_c) - 1)], False)
        cmask = cm0 + 2 * cm1
        order = np.lexsort((cmask, arity, op, kind, A["level"][ids]))
        ids, kind, op, arity, cmask = (v[order] for v in (ids, kind, op, arity, cmask))
        lvls = A["level"][ids]
        n_leaf = self.n_var + len(self.consts)
        pos = np.zeros(N, np.int64)
        pos[ids] = n_leaf + np.arange(len(ids))
        key = np.stack([lvls, kind, op, arity, cmask], 1)
        cut = np.nonzero(np.any(key[1:] != key[:-1], 1))[0] + 1
        levels: List[list] = [[] for _ in range(int(lvls.max(initial=0)))]
        for lo, hi in zip(np.r_[0, cut], np.r_[cut, len(ids)]):
            if lo == hi:
                continue
            a, cm = int(arity[lo]), int(cmask[lo])
            mask = (bool(cm & 1), bool(cm & 2))[:a] if kind[lo] < 2 else (False,) * a
            _, ch = self.children(ids[lo:hi])
            ch = ch.reshape(hi - lo, a)
            in_consts = np.array(mask, bool)[None, :] if a else np.zeros((1, 0), bool)
            idx = np.where(ch >= _NODE, pos[np.clip(ch - _NODE, 0, N - 1)],
                           np.where(ch >= 0, ch,
                                    np.where(in_consts, -1 - ch, self.n_var - 1 - ch)))
            levels[int(lvls[lo]) - 1].append(
                ({0: _BIN, 1: _UN, 2: _NA}[int(kind[lo])], int(op[lo]), a, mask, idx))

        def ix(r):
            return int(pos[r - _NODE]) if r >= _NODE else (
                int(r) if r >= 0 else self.n_var - 1 - int(r))
        return _Tape(self.n_var, self.consts, levels, [ix(r) for r in roots])

    def reach(self, starts):
        """(label, variable) pairs, unique: the variables each reference of
        ``starts`` reaches (its label is its position)."""
        A = self.arrays()
        N = len(self.kind)
        lab = np.arange(len(starts), dtype=np.int64)
        ref = np.asarray(starts, np.int64)
        found = []
        while len(ref):
            v = (ref >= 0) & (ref < _NODE)
            found.append(lab[v] * self.n_var + ref[v])
            nd = ref >= _NODE
            pair = np.unique(lab[nd] * N + (ref[nd] - _NODE))
            lab, nodes = pair // N, pair % N
            rep, ref = self.children(nodes)
            lab = lab[rep]
        pairs = np.unique(np.concatenate(found)) if found else np.zeros(0, np.int64)
        return pairs // self.n_var, pairs % self.n_var

    def sum_terms(self, ref):
        """The terms of ref's top-level sums, differences and negations."""
        out, stack = [], [ref]
        while stack:
            r = stack.pop()
            if r >= _NODE and (self.kind[r - _NODE], self.op[r - _NODE]) in (
                    (_BIN, 0), (_BIN, 1), (_UN, 16), (_NA, _OP_SUMLIST)):
                j = r - _NODE
                stack.extend(self.child[self.start[j]:self.start[j] + self.arity[j]])
            else:
                out.append(r)
        return out


def _pairs(labels, variables, n):
    """Symmetric COO (rows, cols): all pairs of the variables of each label
    (labels sorted)."""
    if not len(labels):
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    cut = np.nonzero(np.diff(labels))[0] + 1
    starts = np.r_[0, cut]
    sizes = np.diff(np.r_[starts, len(labels)])
    size_of = np.repeat(sizes, sizes)          # per element: its group's size
    start_of = np.repeat(starts, sizes)
    a = np.repeat(variables, size_of)
    off = np.arange(int(size_of.sum())) - np.repeat(np.cumsum(size_of) - size_of, size_of)
    b = variables[np.repeat(start_of, size_of) + off]
    k = np.unique(a * n + b)
    return (k // n).astype(np.int32), (k % n).astype(np.int32)


class AmplModel:
    """Parsed .nl model: the NLP plus the AMPL side-channel data (suffixes,
    dual initial guess), the AmplSuffixHandler equivalent; ``f_tape`` and
    ``g_tape`` are the compiled tapes."""

    def __init__(self, nlp: NLP, suffixes: Dict[Tuple[str, str], Dict[int, float]],
                 y0: Optional[np.ndarray], f_tape=None, g_tape=None):
        self.nlp = nlp
        self.suffixes = suffixes
        self.y0 = y0
        self.f_tape = f_tape
        self.g_tape = g_tape


def _read_header(data: bytes):
    """The 10 ASCII header lines (both formats) and where the body starts."""
    nl_pos = 0
    header_lines = []
    for _ in range(10):
        end = data.index(b"\n", nl_pos)
        header_lines.append(data[nl_pos:end].decode("ascii"))
        nl_pos = end + 1
    return header_lines, nl_pos


def read_nl_model(path: str) -> AmplModel:
    with open(path, "rb") as fh:
        data = fh.read()
    header_lines, nl_pos = _read_header(data)
    fmt = header_lines[0][:1]
    if fmt not in ("g", "b"):
        raise NotImplementedError(f"unknown .nl format {fmt!r}")
    dims = header_lines[1].split()
    n_var, n_con, n_obj = int(dims[0]), int(dims[1]), int(dims[2])
    hdr = [l.split() for l in header_lines[2:]]
    n_binary = n_integer = 0
    # header line 7 (index 4 after dims): discrete variable counts
    if len(hdr) >= 5 and len(hdr[4]) >= 2:
        n_binary, n_integer = int(hdr[4][0]), int(hdr[4][1])
    if n_binary or n_integer:
        raise NotImplementedError(
            ".nl model has discrete variables; ipopt_torch solves continuous "
            "NLPs (as does the reference ipopt executable)")
    if n_obj > 1:
        raise NotImplementedError("multiple objectives not supported")

    rdr = (_AsciiReader(data, nl_pos) if fmt == "g"
           else _BinaryReader(data, nl_pos))

    comp = _Compiler(n_var)
    con_refs = [comp.const(0.0)] * n_con
    obj_ref = comp.const(0.0)
    obj_sense = 0  # 0 = minimize
    J = [dict() for _ in range(n_con)]
    Gv: Dict[int, float] = {}
    r_L = np.full(n_con, -np.inf)
    r_U = np.full(n_con, np.inf)
    x_L = np.full(n_var, -np.inf)
    x_U = np.full(n_var, np.inf)
    x0 = np.zeros(n_var)
    y0 = None
    suffixes: Dict[Tuple[str, str], Dict[int, float]] = {}
    _SUF_TARGETS = ("var", "con", "obj", "prob")

    while not rdr.at_end():
        tag, hv = rdr.seg_header()
        if tag == "C":
            con_refs[int(hv[0])] = comp.parse(rdr)
        elif tag == "O":
            obj_sense = int(hv[1]) if len(hv) > 1 else 0
            obj_ref = comp.parse(rdr)
        elif tag == "r":
            for i in range(n_con):
                r_L[i], r_U[i] = rdr.bound()
        elif tag == "b":
            for i in range(n_var):
                x_L[i], x_U[i] = rdr.bound()
        elif tag == "k":
            for _ in range(int(hv[0])):
                rdr.int_line()
        elif tag == "J":
            i, cnt = int(hv[0]), int(hv[1])
            for _ in range(cnt):
                j, c = rdr.int_pair()
                J[i][j] = c
        elif tag == "G":
            cnt = int(hv[1])
            for _ in range(cnt):
                j, c = rdr.int_pair()
                Gv[j] = c
        elif tag == "x":
            for _ in range(int(hv[0])):
                j, v = rdr.int_pair()
                x0[j] = v
        elif tag == "d":
            # dual initial guess (AMPL passes the previous solve's duals)
            y0 = np.zeros(n_con)
            for _ in range(int(hv[0])):
                j, v = rdr.int_pair()
                y0[j] = v
        elif tag == "V":
            # defined variable: V i nlin k, then nlin (idx coef) lines + expr
            i, nlin = int(hv[0]), int(hv[1])
            lin = [rdr.int_pair() for _ in range(nlin)]
            comp.define(i, lin, comp.parse(rdr))
        elif tag == "S":
            kind = int(hv[0])
            cnt = int(hv[1])
            name = hv[2] if len(hv) > 2 else ""
            target = _SUF_TARGETS[kind & 3]
            vals = {}
            real = bool(kind & 4)
            for _ in range(cnt):
                j, v = rdr.suf_entry(real)
                vals[j] = v
            suffixes[(target, name)] = vals
        elif tag == "F":
            raise NotImplementedError(
                ".nl segment 'F' (imported functions) not supported")
        elif tag == "L":
            raise NotImplementedError(
                ".nl segment 'L' (logical constraints) not supported")
        else:
            raise ValueError(f"unknown .nl segment: {tag!r}")

    if ("var", "sosno") in suffixes or ("var", "ref") in suffixes:
        raise NotImplementedError(
            "SOS declarations (sosno/ref suffixes) are not supported; the "
            "reference ipopt executable relaxes or rejects them likewise")

    sign = -1.0 if obj_sense == 1 else 1.0  # 1 = maximize

    f_tape = comp.tape([obj_ref])
    g_tape = comp.tape(con_refs)

    o_idx = np.array(sorted(Gv), np.int64)
    o_coef = np.array([Gv[k] for k in sorted(Gv)], np.float64)
    g_rows = np.array([i for i in range(n_con) for _ in J[i]], np.int64)
    g_cols = np.array([j for i in range(n_con) for j in sorted(J[i])], np.int64)
    g_coef = np.array([J[i][j] for i in range(n_con) for j in sorted(J[i])],
                      np.float64)
    lin_host = dict(o_idx=o_idx, o_coef=o_coef, g_rows=g_rows, g_cols=g_cols,
                    g_coef=g_coef)
    lin_cache: Dict[Any, Dict[str, torch.Tensor]] = {}

    def lin(x):
        """The linear parts' index and coefficient tensors on x's device."""
        key = (x.dtype, x.device)
        if key not in lin_cache:
            lin_cache[key] = {k: torch.as_tensor(
                v, device=x.device, dtype=x.dtype if v.dtype == np.float64 else None)
                for k, v in lin_host.items()}
        return lin_cache[key]

    def f(x):
        val = f_tape(x)[0]
        if o_idx.size:
            t = lin(x)
            val = val + torch.dot(t["o_coef"], x[t["o_idx"]])
        return sign * val

    def g(x):
        val = g_tape(x)
        if g_rows.size:
            t = lin(x)
            val = val.index_add(0, t["g_rows"], t["g_coef"] * x[t["g_cols"]])
        return val

    # the declared patterns: the Jacobian's from the J segments and the
    # trees; the Hessian's from each constraint and each objective term
    c_lab, c_var = comp.reach(con_refs)
    jk = np.unique(np.concatenate([g_rows * n_var + g_cols, c_lab * n_var + c_var]))
    jac_pat = ((jk // max(n_var, 1)).astype(np.int32),
               (jk % max(n_var, 1)).astype(np.int32))
    o_lab, o_var = comp.reach(comp.sum_terms(obj_ref))
    hess_pat = _pairs(np.concatenate([c_lab, n_con + o_lab]),
                      np.concatenate([c_var, o_var]), n_var)

    # warm-start duals from suffixes (ampl_ipopt.cpp:77-83)
    zl = suffixes.get(("var", "ipopt_zL_in"))
    zu = suffixes.get(("var", "ipopt_zU_in"))
    z_L0 = z_U0 = None
    if zl:
        z_L0 = np.zeros(n_var)
        for j, v in zl.items():
            z_L0[j] = v
    if zu:
        z_U0 = np.zeros(n_var)
        for j, v in zu.items():
            z_U0[j] = v

    nlp = NLP(f=f, g=g if n_con else None, x0=x0, x_L=x_L, x_U=x_U,
              g_L=r_L if n_con else None, g_U=r_U if n_con else None,
              jac_g_sparsity=jac_pat if n_con else None,
              lag_hess_sparsity=hess_pat,
              y0=y0, z_L0=z_L0, z_U0=z_U0, name=path)
    return AmplModel(nlp, suffixes, y0, f_tape, g_tape)


def read_nl(path: str) -> NLP:
    """The NLP of a .nl file."""
    return read_nl_model(path).nlp


def ascii_nl_to_binary(src: str, dst: str):
    """Transcode an ASCII ('g') .nl file to the binary ('b') format, token by
    token."""
    with open(src, "rb") as fh:
        data = fh.read()
    header_lines, nl_pos = _read_header(data)
    if not header_lines[0].startswith("g"):
        raise ValueError("source must be ASCII format")
    dims = header_lines[1].split()
    n_var, n_con = int(dims[0]), int(dims[1])

    rdr = _AsciiReader(data, nl_pos)
    out = bytearray()
    out += ("b" + header_lines[0][1:] + "\n").encode()
    for l in header_lines[1:]:
        out += (l + "\n").encode()
    pack_i, pack_d = struct.Struct("<i").pack, struct.Struct("<d").pack

    def put_i(v):
        out.extend(pack_i(int(v)))

    def put_d(v):
        out.extend(pack_d(float(v)))

    def put_expr():
        todo = 1
        while todo:
            todo -= 1
            kind, val = rdr.expr_node()
            out.append(ord(kind))
            if kind == "n":
                put_d(val)
                continue
            put_i(val)
            if kind == "v":
                continue
            if val in _BINOPS:
                todo += 2
            elif val in _UNOPS:
                todo += 1
            elif val in _NARY:
                cnt = rdr.int_line()
                put_i(cnt)
                todo += cnt
            else:
                raise NotImplementedError(f"opcode {val}")

    def put_bound():
        tokens = rdr.lines[rdr.pos].split()
        rdr.pos += 1
        code = int(tokens[0])
        put_i(code)
        for t in tokens[1:1 + (2 if code == 0 else (0 if code == 3 else 1))]:
            put_d(t)

    while not rdr.at_end():
        tag, hv = rdr.seg_header()
        out.append(ord(tag))
        if tag == "C":
            put_i(hv[0])
            put_expr()
        elif tag == "O":
            put_i(hv[0])
            put_i(hv[1] if len(hv) > 1 else 0)
            put_expr()
        elif tag == "r":
            for _ in range(n_con):
                put_bound()
        elif tag == "b":
            for _ in range(n_var):
                put_bound()
        elif tag == "k":
            cnt = int(hv[0])
            put_i(cnt)
            for _ in range(cnt):
                put_i(rdr.int_line())
        elif tag in ("J", "G"):
            put_i(hv[0])
            cnt = int(hv[1])
            put_i(cnt)
            for _ in range(cnt):
                j, c = rdr.int_pair()
                put_i(j)
                put_d(c)
        elif tag in ("x", "d"):
            cnt = int(hv[0])
            put_i(cnt)
            for _ in range(cnt):
                j, v = rdr.int_pair()
                put_i(j)
                put_d(v)
        elif tag == "V":
            put_i(hv[0])
            put_i(hv[1])
            put_i(hv[2])
            for _ in range(int(hv[1])):
                j, c = rdr.int_pair()
                put_i(j)
                put_d(c)
            put_expr()
        elif tag == "S":
            put_i(hv[0])
            put_i(hv[1])
            out += (hv[2] + "\n").encode()
            real = bool(int(hv[0]) & 4)
            for _ in range(int(hv[1])):
                j, v = rdr.int_pair()
                put_i(j)
                (put_d if real else put_i)(v)
        else:
            raise NotImplementedError(f"segment {tag}")
    with open(dst, "wb") as fh:
        fh.write(bytes(out))


def write_luksan_vlcek1_nl(path: str, n: int):
    """LuksanVlcek1 (``modellib.luksan_vlcek1_flat``) written as an ASCII .nl
    file the way AMPL writes an indexed model: the objective one o54 sum of
    2(n-1) terms, each of the n - 2 equalities an o54 sum of its nonlinear
    terms and constants, its linear terms (4 x_{j+1} + 2 x_{j+2}) in a J
    segment that lists every variable of the row."""
    if n < 4:
        raise ValueError(f"need n >= 4, got {n}")
    m = n - 2
    out = [f"g3 1 1 0\t# LuksanVlcek1 n = {n}",
           f" {n} {m} 1 0 {m}\t# vars, constraints, objectives, ranges, eqns",
           f" {m} 1\t# nonlinear constraints, objectives",
           " 0 0\t# network constraints: nonlinear, linear",
           f" {n} {n} {n}\t# nonlinear vars in constraints, objectives, both",
           " 0 0 0 1\t# linear network variables; functions; arith, flags",
           " 0 0 0 0 0\t# discrete variables: binary, integer, nonlinear (b,c,o)",
           f" {3 * m} {n}\t# nonzeros in Jacobian, gradients",
           " 0 0\t# max name lengths: constraints, variables",
           " 0 0 0 0 0\t# common exprs: b,c,o,c1,o1"]
    for j in range(m):
        a, b, c = j, j + 1, j + 2
        # 3 b^3 - 5 + sin(b - c) sin(b + c) - a exp(a - b) - 3
        out += [f"C{j}", "o54", "5", "o2", "n3", "o5", f"v{b}", "n3", "n-5",
                "o2", "o41", "o1", f"v{b}", f"v{c}", "o41", "o0", f"v{b}", f"v{c}",
                "o16", "o2", f"v{a}", "o44", "o1", f"v{a}", f"v{b}", "n-3"]
    out += ["O0 0", "o54", str(2 * (n - 1))]
    for i in range(n - 1):
        # 100 (x_i^2 - x_{i+1})^2 + (x_i - 1)^2
        out += ["o2", "n100", "o5", "o1", "o5", f"v{i}", "n2", f"v{i + 1}", "n2",
                "o5", "o1", f"v{i}", "n1", "n2"]
    out += ["x" + str(n)] + [f"{i} {-1.0 if i % 2 == 0 else 1.0:g}" for i in range(n)]
    out += ["r"] + ["4 0"] * m
    out += ["b"] + ["3"] * n
    # cumulative column counts of the Jacobian (the first n - 1 columns)
    per_col = np.array([sum(1 for j in (i - 2, i - 1, i) if 0 <= j < m)
                        for i in range(n)])
    out += [f"k{n - 1}"] + [str(v) for v in np.cumsum(per_col)[:-1]]
    for j in range(m):
        out += [f"J{j} 3", f"{j} 0", f"{j + 1} 4", f"{j + 2} 2"]
    out += [f"G0 {n}"] + [f"{i} 0" for i in range(n)]
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def write_sol(path: str, res, message: str = "", n_var: Optional[int] = None,
              extra_var_suffixes: Optional[Dict[str, Any]] = None):
    """Write AMPL's .sol format (what ampl_ipopt.cpp emits through ASL's
    write_sol), with the ipopt_zL_out/ipopt_zU_out bound multiplier suffixes
    (AmplTNLP::finalize_solution).  ``extra_var_suffixes``: more real
    variable suffixes (name -> (n_var,) array), the sIPOPT
    sens_sol_state_1* outputs."""
    def host(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, float)
    y = host(res.g_duals if hasattr(res, "g_duals") else res.y)
    x = host(res.x)
    z_L = host(res.z_L) if hasattr(res, "z_L") else None
    z_U = host(res.z_U) if hasattr(res, "z_U") else None
    with open(path, "w") as fh:
        fh.write((message or "ipopt_torch") + "\n\n")
        fh.write("Options\n3\n0\n1\n0\n")
        fh.write(f"{len(y)}\n{len(y)}\n{len(x)}\n{len(x)}\n")
        for v in y:
            fh.write(f"{v:.17g}\n")
        for v in x:
            fh.write(f"{v:.17g}\n")
        fh.write(f"objno 0 {0 if int(res.status) == 0 else 200}\n")
        # suffix sections: kind 4|0 = real var suffix
        sections = [("ipopt_zL_out", z_L), ("ipopt_zU_out", z_U)]
        for name, vals in (extra_var_suffixes or {}).items():
            sections.append((name, host(vals)))
        for name, z in sections:
            if z is None:
                continue
            nz = [(i, v) for i, v in enumerate(z) if v != 0.0]
            fh.write(f"suffix 4 {len(nz)} {len(name) + 1} 0 0\n{name}\n")
            for i, v in nz:
                fh.write(f"{i} {v:.17g}\n")


def read_sol(path: str):
    """Read a .sol file back: (primals, duals, status, suffixes)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while lines[i].strip() != "Options":
        i += 1
    n_opts = int(lines[i + 1])
    i = i + 2 + n_opts
    n_y_max, n_y, n_x_max, n_x = (int(lines[i]), int(lines[i + 1]),
                                  int(lines[i + 2]), int(lines[i + 3]))
    i += 4
    y = np.array([float(lines[i + k]) for k in range(n_y)])
    i += n_y
    x = np.array([float(lines[i + k]) for k in range(n_x)])
    i += n_x
    status = None
    suffixes: Dict[str, Dict[int, float]] = {}
    while i < len(lines):
        l = lines[i].strip()
        if l.startswith("objno"):
            status = int(l.split()[2])
            i += 1
        elif l.startswith("suffix"):
            parts = l.split()
            cnt = int(parts[2])
            name = lines[i + 1].strip()
            vals = {}
            for k in range(cnt):
                t = lines[i + 2 + k].split()
                vals[int(t[0])] = float(t[1])
            suffixes[name] = vals
            i += 2 + cnt
        else:
            i += 1
    return x, y, status, suffixes


def run_sens_from_suffixes(model: AmplModel, opts: Options, res, device=None):
    """The sIPOPT AMPL protocol (SensAmplTNLP, SensBuilder.cpp:88-140):
    parameters are variables pinned by equality rows marked with the
    ``sens_init_constr`` suffix; ``sens_state_1`` / ``sens_state_value_1``
    give the perturbation; the estimated perturbed solution is returned as
    the ``sens_sol_state_1`` (+ ``_z_L``/``_z_U``) variable suffixes.
    Returns the extra-suffix dict for write_sol, or None if the suffixes
    are absent."""
    from torch.func import grad
    from ..problem import canonicalize
    from ..sens import perturbed_solution_rhs
    init_marks = model.suffixes.get(("con", "sens_init_constr"))
    st1 = model.suffixes.get(("var", "sens_state_1"))
    sv1 = model.suffixes.get(("var", "sens_state_value_1"))
    if not (init_marks and st1 and sv1):
        return None
    nlp = model.nlp
    cnlp = canonicalize(nlp, opts)
    s = cnlp.struct
    eq_pos_of_row = {int(r): p for p, r in enumerate(np.asarray(s.eq_idx))}
    x_res = np.asarray(res.x.detach().cpu(), np.float64)
    x_sol = torch.as_tensor(x_res, dtype=cnlp.dtype)

    new_crhs = cnlp.c_rhs[0].detach().cpu().numpy().astype(np.float64).copy()
    for row, mark in init_marks.items():
        if not mark or int(row) not in eq_pos_of_row:
            continue
        pos = eq_pos_of_row[int(row)]
        # the pinned variable = the dominant entry of the row gradient
        grad_row = grad(lambda xx, r=int(row): nlp.g(xx)[r])(x_sol)
        var = int(torch.argmax(grad_row.abs()))
        if var in sv1:
            # the row reads coeff * x_var - rhs = 0: move rhs so that the
            # pinned variable lands on sens_state_value_1
            coeff = float(grad_row[var])
            new_crhs[pos] = float(new_crhs[pos]) + coeff * (float(sv1[var])
                                                            - x_res[var])
    # the reference solves on the factorization of the last barrier problem
    # (mu = final mu): mu = 0 can leave free-variable diagonals exactly
    # singular for the unpivoted factorization
    it_pert = perturbed_solution_rhs(
        cnlp, opts, res.iterate, new_crhs[None], mu=float(res.mu),
        n_steps=opts.n_sens_steps, boundcheck=opts.sens_boundcheck,
        bound_eps=opts.sens_bound_eps, device=device)
    from ..algorithm.solver import _x_user
    def host(v):
        return v.detach().reshape(-1).cpu().numpy()
    x_pert = host(_x_user(cnlp.to(it_pert.x.device), it_pert.x.reshape(1, -1)))
    zl = np.zeros(s.n_full)
    zu = np.zeros(s.n_full)
    zl[np.asarray(s.free_idx)] = host(it_pert.z_L)
    zu[np.asarray(s.free_idx)] = host(it_pert.z_U)
    return {"sens_sol_state_1": x_pert,
            "sens_sol_state_1_z_L": zl,
            "sens_sol_state_1_z_U": zu}


def compute_red_hessian_from_suffixes(model: AmplModel, opts: Options, res,
                                      device=None):
    """compute_red_hessian (SensApplication.cpp:73, SensBuilder.cpp:137): the
    reduced Hessian over the variables with the ``red_hessian`` suffix,
    ordered by the suffix value."""
    marks = model.suffixes.get(("var", "red_hessian"))
    if not marks:
        return None
    from ..problem import canonicalize
    from ..sens import reduced_hessian
    cnlp = canonicalize(model.nlp, opts)
    order = sorted((int(v), int(i)) for i, v in marks.items() if v)
    idx = [i for _, i in order]
    H = reduced_hessian(cnlp, opts, res.iterate, np.asarray(idx, np.int64),
                        mu=float(res.mu), device=device)
    return H.detach().cpu().numpy().reshape(len(idx), len(idx))


def _parse_overrides(args):
    """option=value arguments: yes/no/true/false/1/0 for booleans (the Ipopt
    CLI convention), numbers, else strings."""
    overrides = {}
    for a in args:
        if a == "-AMPL" or "=" not in a:
            continue
        k, v = a.split("=", 1)
        fld = Options.__dataclass_fields__.get(k)
        if fld is not None and fld.type in ("bool", bool):
            overrides[k] = v.strip().lower() in ("yes", "true", "1")
            continue
        try:
            overrides[k] = float(v) if "." in v or "e" in v else int(v)
        except ValueError:
            overrides[k] = v
    return overrides


def main(argv=None):
    from ..algorithm.solver import solve
    from ..types import SolverReturn
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m ipopt_torch.interfaces.ampl model.nl "
              "[-AMPL] [device=cpu] [option=value ...]")
        return 2
    nl_path = argv[0]
    overrides = _parse_overrides(argv[1:])
    device = overrides.pop("device", None)
    model = read_nl_model(nl_path)
    nlp = model.nlp
    # scaling_factor suffixes (AmplSuffixHandler): objective scaling via the
    # obj suffix
    sf_obj = model.suffixes.get(("obj", "scaling_factor"))
    if sf_obj and 0 in sf_obj:
        overrides.setdefault("nlp_scaling_method", "user-scaling")
        overrides.setdefault("obj_scaling_factor", float(sf_obj[0]))
    if nlp.y0 is not None or nlp.z_L0 is not None:
        overrides.setdefault("warm_start_init_point", True)
    res = solve(nlp, device=device, print_level=overrides.pop("print_level", 5),
                **overrides)
    status = SolverReturn(int(res.status))
    ok = status in (SolverReturn.SUCCESS, SolverReturn.STOP_AT_ACCEPTABLE_POINT)
    msg = "ipopt_torch: Optimal Solution Found" if ok else f"ipopt_torch: {status.name}"
    sol_path = nl_path[:-3] + ".sol" if nl_path.endswith(".nl") else nl_path + ".sol"
    extra = None
    opts_used = Options().replace(
        **{k: v for k, v in overrides.items() if k in Options.__dataclass_fields__})
    if opts_used.run_sens and ok:
        extra = run_sens_from_suffixes(model, opts_used, res, device=device)
    if opts_used.compute_red_hessian:
        rh = compute_red_hessian_from_suffixes(model, opts_used, res, device=device)
        if rh is not None:
            print("Reduced Hessian (red_hessian suffix order):")
            for row in rh:
                print("  " + " ".join(f"{v: .9e}" for v in row))
    write_sol(sol_path, res, msg, extra_var_suffixes=extra)
    print(msg)
    if ok:
        print("EXIT: Optimal Solution Found.")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
